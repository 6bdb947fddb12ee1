// The native bfloat16 prolongation-add of transfer2d: out = x + P e on the
// fine interior, x elsewhere, in one launch, each thread on a block of fine
// points that share their coarse values, native_prolong_add_kernel.
//
// Replaces the bfloat16 mode of the TPU kernel
// multigridcmt_tpu/kernels/transfer2d.py:
//   prolong_add -> transfer2d_prolong_add_native (:204)
// (kernels/native_bf16.py states the rule and JAX's order): P interpolates
// columns first, then rows; fine 2I takes coarse I, an odd point the
// average 0.5 a + 0.5 b of its two neighbours in float32 (both products
// exact), rounded to bfloat16 once; then x + P e is one float32 add
// rounded to bfloat16. The bits equal native_bf16.prolong_add_plain(...,
// rows_first=False)'s. The fused up leg's prolongation (the row stream)
// takes rows first: other bits.
//
// What bounds it on the card: device-memory traffic (x read and out
// written once, 2 bytes a fine point each, e's quarter-size grid read once:
// 4.5 bytes a fine point, 0.0056 ms at 2047^2 on an H100). The arithmetic,
// some 4 rounded operations a fine point, is far below. The kernel it
// replaces (native_bf16.cu's, a thread a fine point) made 2-byte accesses
// and loaded up to four coarse values a point, three column averages of an
// odd-odd point recomputed by its neighbours.
//
// Design. The fine grid's row pitch C = n + 2 is odd, so a row's words of
// two bfloat16 alternate: on an even row 2I the word pairs columns (2J,
// 2J + 1), on the odd row below it (2J - 1, 2J), and the odd row's J = 0
// word is the even row's column n + 1 with the odd row's column 0, both
// ghosts. So the rows 2I and 2I + 1 are C words, the even row's J = 0 .. nc
// and the odd row's J = 0 .. nc + 1, every one aligned (the launcher takes
// arrays that start on a 4-byte word); the grid's last point, row n + 1's
// column n + 1, is a half word of its own. Thread (I, J), I, J = 0 .. nc +
// 1, owns word J of both rows of row pair I (the last pair is row n + 1 and
// that half word): 4 fine points. It needs coarse columns J - 1 .. J + 1 of
// coarse rows I and I + 1, which it loads once each as two aligned words of
// e a row (whose pitch nc + 2 is odd too: a funnel shift by the row's
// parity lines them up), averages each pair of neighbouring columns once a
// coarse row (the odd fine columns' values), and averages the two coarse
// rows' column values for the odd fine row. Consecutive threads take
// consecutive words of a row pair, so a warp's loads and stores of x and
// out are contiguous. Every fine point is written exactly once; the ghosts
// keep x's bits (a mask, not a rounding). No shared memory: the coarse
// grid, a quarter of the fine one, is read once and stays in L2. A thread
// of two words (four coarse values a row) read faster at 2047^2 only, by
// 0.002 ms of a host-bound cycle (PERF.md): one word a thread keeps one
// instance.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;    // threads a block

// 0.5 a + 0.5 b in float32 (both products exact), rounded to bfloat16
// once, held in a float.
__device__ __forceinline__ float average(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(
      __fadd_rn(__fmul_rn(0.5f, a), __fmul_rn(0.5f, b))));
}

// The word of two bfloat16 at element 2 w of e (total elements, odd),
// through the read-only cache: the last element's half word alone, and 0
// off the array (only ghost points, which take x's values, read those).
__device__ __forceinline__ unsigned coarse_word(const bf16* __restrict__ e,
                                                long long w, long long total) {
  const long long i = 2 * w;
  if (i >= 0 && i + 1 < total) {
    return __ldg(reinterpret_cast<const unsigned*>(e) + w);
  }
  if (i >= 0 && i < total) {
    return __ldg(reinterpret_cast<const unsigned short*>(e) + i);
  }
  return 0u;
}

// Coarse row I's values at columns J - 1, J and J + 1 into v, from the two
// aligned words that cover them, shifted by the first one's parity.
__device__ __forceinline__ void coarse_three(const bf16* __restrict__ e,
                                             int I, int J, int Cc,
                                             long long total, float (&v)[3]) {
  const long long q = static_cast<long long>(I) * Cc + J - 1;
  const int s = static_cast<int>(q & 1);
  const long long w0 = (q - s) / 2;
  const unsigned a = coarse_word(e, w0, total);
  const unsigned b = coarse_word(e, w0 + 1, total);
  // Elements q and q + 1 in the low and high half; q + 2 is b's low half
  // (s = 0) or its high half (s = 1).
  const unsigned p = __funnelshift_r(a, b, 16 * s);
  v[0] = mg::low_f(p);
  v[1] = mg::high_f(p);
  v[2] = s ? mg::high_f(b) : mg::low_f(b);
}

// The word of two fine points: x's word xw with each interior half (lo,
// hi) replaced by x + P e rounded to bfloat16 (pe: P e there, a bfloat16
// value in a float).
__device__ __forceinline__ unsigned add_word(unsigned xw, float pe_lo,
                                             float pe_hi, bool lo, bool hi) {
  const unsigned sum = mg::pack_bf16(__fadd_rn(mg::low_f(xw), pe_lo),
                                     __fadd_rn(mg::high_f(xw), pe_hi));
  const unsigned keep = (lo ? 0u : 0x0000ffffu) | (hi ? 0u : 0xffff0000u);
  return (sum & ~keep) | (xw & keep);
}

// Word J of rows 2I and 2I + 1, as the note says.
__global__ void __launch_bounds__(kThreads)
native_prolong_add_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ e, bf16* __restrict__ out,
                          int n) {
  const int nc = (n - 1) / 2;
  const int Cc = nc + 2;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int I = t / Cc;
  if (I > nc + 1) return;
  const int J = t - I * Cc;
  const long long total = static_cast<long long>(Cc) * Cc;
  const long long C = n + 2;
  const unsigned* xw = reinterpret_cast<const unsigned*>(x);
  unsigned* ow = reinterpret_cast<unsigned*>(out);
  // Row pair I's first word: the even row's J = 0; the odd row's J = 0
  // follows the even row's nc + 1 words.
  const long long even = static_cast<long long>(I) * C;
  const long long odd = even + nc + 1;

  float v0[3], v1[3];             // coarse rows I, I + 1
  coarse_three(e, I, J, Cc, total, v0);
  coarse_three(e, I + 1, J, Cc, total, v1);
  const bool row_even = I >= 1 && I <= nc;   // fine row 2I interior
  // Even row 2I: columns 2J (coarse J) and 2J + 1 (the columns' average).
  if (J <= nc) {
    const long long k = even + J;
    ow[k] = add_word(__ldg(xw + k), v0[1], average(v0[1], v0[2]),
                     row_even && J >= 1, row_even);
  }
  // Odd row 2I + 1: columns 2J - 1 and 2J, each the average of the two
  // coarse rows' column values (J = 0: ghosts, row 2I's column n + 1 and
  // this row's column 0).
  if (I <= nc) {
    const long long k = odd + J;
    ow[k] = add_word(__ldg(xw + k),
                     average(average(v0[0], v0[1]), average(v1[0], v1[1])),
                     average(v0[1], v1[1]), J >= 1, J >= 1 && J <= nc);
  }
  // The last row pair's "odd" word J = 0 is the grid's last point alone.
  if (I == nc + 1 && J == 0) {
    const long long i = 2 * odd;
    reinterpret_cast<unsigned short*>(out)[i] =
        reinterpret_cast<const unsigned short*>(x)[i];
  }
}

}  // namespace

extern "C" {

// x, out: (n+2)^2 bfloat16 and e: ((n-1)/2 + 2)^2 bfloat16, each starting
// on a 4-byte word; n = 2 nc + 1 >= 3.
int mg_transfer2d_prolong_add_native_bf16(const void* x, const void* e,
                                          void* out, int n, void* stream) {
  const auto bits = reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(e) |
                    reinterpret_cast<uintptr_t>(out);
  if (n < 3 || n % 2 == 0 || bits % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long words = static_cast<long long>((n - 1) / 2 + 2) *
                          ((n - 1) / 2 + 2);
  native_prolong_add_kernel<<<
      static_cast<unsigned>((words + kThreads - 1) / kThreads), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(e),
      static_cast<bf16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The bfloat16 storage mode of the packed2d up leg (packed2d_legs.cuh's
// up_kernel with bfloat16 x, b and out, a float coarse correction and
// float registers), in a file of its own so that it compiles beside the
// float32 and float64 up legs and does not lengthen them.
//
// Replaces the bfloat16 mode of the TPU kernel
// multigridcmt_tpu/kernels/packed2d.py:
//   prolong_add_smooth -> packed2d_up_bf16 (up_kernel, :1067)
// as the TPU kernel runs it: x' rounded to bfloat16 once, on its store. No
// solver of the port runs it: the top level of a mixed cycle emits float
// (packed2d_up_bf16_f32.cu).
#include "packed2d_legs.cuh"

extern "C" {

int mg_packed2d_up_bf16(const void* x, const void* e, const void* b,
                        void* out, int n, double h, double sigma, int kind,
                        double omega, int sweeps, int packed_e,
                        const int* geom, void* stream) {
  return launch_up<float, kMaxUpStages, Whole, __nv_bfloat16>(
      x, e, b, out, Whole{n}, h, sigma, kind, omega, sweeps, packed_e, geom,
      stream);
}

}  // extern "C"

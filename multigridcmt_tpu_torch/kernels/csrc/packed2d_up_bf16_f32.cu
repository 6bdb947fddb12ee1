// The packed2d up leg with bfloat16 x and b, a float coarse correction and
// a float x' (packed2d_legs.cuh's up_kernel, O = float): the top level of a
// mixed cycle, in a file of its own so that it compiles beside the other up
// legs.
//
// The TPU kernel multigridcmt_tpu/kernels/packed2d.py:1067
// (prolong_add_smooth) has no wider output: in a mixed cycle it stores the
// top level in bfloat16, and the final store's O(eps_bf16 / h^2) noise
// makes the preconditioner break down as k grows (MG-PCG at 4095^2 float32
// stalls after 3 iterations). JAX's sharded tier repairs the same fault
// with a float-emitting top level (local2d.up_leg's out_dtype), and this is
// that repair on the single-device packed tier: x + P e and the sweeps are
// computed in float registers from the widened x and b, as in the bfloat16
// mode, and stored in float.
#include "packed2d_legs.cuh"

extern "C" {

int mg_packed2d_up_bf16_f32(const void* x, const void* e, const void* b,
                            void* out, int n, double h, double sigma,
                            int kind, double omega, int sweeps, int packed_e,
                            const int* geom, void* stream) {
  return launch_up<float, kMaxUpStages, Whole, __nv_bfloat16, float>(
      x, e, b, out, Whole{n}, h, sigma, kind, omega, sweeps, packed_e, geom,
      stream);
}

}  // extern "C"

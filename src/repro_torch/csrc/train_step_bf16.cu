// The fused train step's host-sampled variant, bf16 policy (bfloat16 params and
// compute, float32 gradients; the kernel, its rounding points and its design:
// train_step.cuh). A translation unit of its own so that nvcc compiles its 12
// kernels (W x F) beside the others.
#include "train_step.cuh"

namespace repro {

cudaError_t train_step_launch_bf16(const StepArgs& a, const StepShape& sh, long long P,
                                   int W, int F, cudaStream_t stream) {
  return step_launch<__nv_bfloat16, false, false>(a, sh, P, W, F, stream);
}

}  // namespace repro

// The fused train step's bf16-policy instantiations (bfloat16 params and
// compute, float32 gradients; the kernel, its rounding points and its
// design: train_step.cuh). A translation unit of its own so that nvcc
// compiles its 24 kernels (W x F x variant) beside train_step.cu's float32
// ones.
#include "train_step.cuh"

namespace repro {

cudaError_t train_step_launch_bf16(const StepArgs& a, const StepShape& sh,
                                   long long P, int W, int F, bool sampling,
                                   cudaStream_t stream) {
  return step_launch<__nv_bfloat16, false>(a, sh, P, W, F, sampling, stream);
}

}  // namespace repro

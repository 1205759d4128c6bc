// The fused train step's in-kernel-sampling variant, float32 policy (the kernel
// and its design: train_step.cuh). A translation unit of its own so that nvcc
// compiles its 12 kernels (W x F) beside the others.
#include "train_step.cuh"

namespace repro {

cudaError_t train_step_launch_sampling(const StepArgs& a, const StepShape& sh,
                                       long long P, int W, int F, cudaStream_t stream) {
  return step_launch<float, false, true>(a, sh, P, W, F, stream);
}

}  // namespace repro

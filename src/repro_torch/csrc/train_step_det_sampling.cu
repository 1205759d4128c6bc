// The fused train step's deterministic route, float32 policy, in-kernel-
// sampling variant (the route: train_step.cuh, DET). A translation unit of its
// own so that nvcc compiles its 12 kernels (W x F) beside the others.
#include "train_step.cuh"

namespace repro {

cudaError_t train_step_launch_det_sampling(const StepArgs& a, const StepShape& sh,
                                           long long P, int W, int F,
                                           cudaStream_t stream) {
  return step_launch<float, true, true>(a, sh, P, W, F, stream);
}

}  // namespace repro

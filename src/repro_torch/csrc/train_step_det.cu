// The fused train step's deterministic route, float32 policy, host-sampled
// variant (the route and its design: train_step.cuh, DET; the fixed-point table
// gradient: hash_grid.cuh). A translation unit of its own so that nvcc compiles
// its 12 kernels (W x F) beside the others.
#include "train_step.cuh"

namespace repro {

cudaError_t train_step_launch_det(const StepArgs& a, const StepShape& sh, long long P,
                                  int W, int F, cudaStream_t stream) {
  return step_launch<float, true, false>(a, sh, P, W, F, stream);
}

}  // namespace repro

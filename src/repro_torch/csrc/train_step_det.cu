// The fused train step's deterministic route, float32 policy (the route and
// its design: train_step.cuh, DET; the fixed-point table gradient:
// hash_grid.cuh). A translation unit of its own so that nvcc compiles its 24
// kernels (W x F x variant) beside the default route's.
#include "train_step.cuh"

namespace repro {

cudaError_t train_step_launch_det(const StepArgs& a, const StepShape& sh,
                                  long long P, int W, int F, bool sampling,
                                  cudaStream_t stream) {
  return step_launch<float, true>(a, sh, P, W, F, sampling, stream);
}

}  // namespace repro

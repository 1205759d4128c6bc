// The fused train step's deterministic route, bf16 policy (the route:
// train_step.cuh, DET; the bf16 rounding points: its header). A translation
// unit of its own so that nvcc compiles its 24 kernels beside the others.
#include "train_step.cuh"

namespace repro {

cudaError_t train_step_launch_det_bf16(const StepArgs& a, const StepShape& sh,
                                       long long P, int W, int F, bool sampling,
                                       cudaStream_t stream) {
  return step_launch<__nv_bfloat16, true>(a, sh, P, W, F, sampling, stream);
}

}  // namespace repro

// The fused train step's deterministic route, bf16 policy, host-sampled variant
// (the route: train_step.cuh, DET; the bf16 rounding points: its header). A
// translation unit of its own so that nvcc compiles its 12 kernels (W x F)
// beside the others.
#include "train_step.cuh"

namespace repro {

cudaError_t train_step_launch_det_bf16(const StepArgs& a, const StepShape& sh,
                                       long long P, int W, int F, cudaStream_t stream) {
  return step_launch<__nv_bfloat16, true, false>(a, sh, P, W, F, stream);
}

}  // namespace repro

// The fused train step's deterministic route as it was before the split: the
// fixed-point table adds inside the step, every level straight to device
// memory (train_step_det_fused_kernel, train_step.cuh). The yardstick of the
// split route at W = 16, F = 4: both policies, both variants, and the
// float32 sampling variant with the stage clock. A translation unit of its
// own so that nvcc compiles its 5 kernels beside the others.
#include "train_step.cuh"

namespace repro {

namespace {

template <typename TP, bool SAMPLING, typename Clk>
cudaError_t launch_fused(const StepArgs& a, const StepShape& sh, long long P,
                         cudaStream_t stream) {
  const auto kernel = &train_step_det_fused_kernel<TP, SAMPLING, Clk>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (e != cudaSuccess) return e;
  REPRO_NOTE_LAUNCH(kernel, sh.smem);
  kernel<<<dim3((unsigned)sh.blocks, (unsigned)P), sh.tile, sh.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t train_step_launch_det_fused(const StepArgs& a, const StepShape& sh,
                                        long long P, int W, int F, int is_bf16,
                                        int sampling, int clocked, cudaStream_t stream) {
  if (W != 16 || F != 4) return cudaErrorInvalidValue;
  if (clocked) {
    if (is_bf16 || !sampling || a.clocks == nullptr) return cudaErrorInvalidValue;
    return launch_fused<float, true, step::DetStageClock>(a, sh, P, stream);
  }
  if (is_bf16)
    return sampling ? launch_fused<__nv_bfloat16, true, step::StepNoClock>(a, sh, P, stream)
                    : launch_fused<__nv_bfloat16, false, step::StepNoClock>(a, sh, P, stream);
  return sampling ? launch_fused<float, true, step::StepNoClock>(a, sh, P, stream)
                  : launch_fused<float, false, step::StepNoClock>(a, sh, P, stream);
}

}  // namespace repro

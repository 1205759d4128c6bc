// The INR inference kernel's bf16 instantiations (the kernel and its
// design: inr_forward.cuh). A translation unit of its own so that nvcc
// compiles them beside inr_forward.cu's float32 ones.
#include "inr_forward.cuh"

namespace repro {
namespace inr {

cudaError_t dispatch_bf16(int W, int F, int design, const Args& a) {
  return dispatch<__nv_bfloat16>(W, F, design, a);
}

}  // namespace inr
}  // namespace repro

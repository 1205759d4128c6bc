// Shared helpers of the port's CUDA kernels: element loads/stores in the
// storage type (float32 or bfloat16) with float32 arithmetic in between.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// max(v, 0) with NaN passed through, like jnp.maximum(v, 0)
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// Round a float32 value to the storage type and back: the rounding a value
// takes when the reference stores it in T between two operations.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace repro

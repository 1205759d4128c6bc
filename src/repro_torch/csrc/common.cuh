// Shared helpers of the port's CUDA kernels: element loads/stores in the
// storage type (float32 or bfloat16) with float32 arithmetic in between.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

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

// ---------------------------------------------------------------------------
// The launch notes: every launch site records the kernel it launches and the
// dynamic shared memory it asks for (REPRO_NOTE_LAUNCH, just before the
// launch), so that repro_kernel_launches (launch_notes.cu) can hand the
// kernels a program launched, with their cudaFuncGetAttributes, to the
// port's kernel_budget check. One table for the library (the functions'
// statics are shared by every source that includes this header); a launch
// costs a scan of the table's few entries and two atomic updates.
struct LaunchNote {
  std::atomic<const void*> fn{nullptr};
  std::atomic<long long> launches{0};
  std::atomic<long long> max_dynamic_smem{0};
};
constexpr int MAX_LAUNCH_NOTES = 512;

inline LaunchNote* launch_notes() {
  static LaunchNote notes[MAX_LAUNCH_NOTES];
  return notes;
}

inline std::atomic<int>& launch_note_count() {
  static std::atomic<int> n{0};
  return n;
}

inline void note_launch(const void* fn, size_t dynamic_smem) {
  LaunchNote* notes = launch_notes();
  std::atomic<int>& count = launch_note_count();
  LaunchNote* hit = nullptr;
  for (int i = 0, n = count.load(std::memory_order_acquire); i < n; ++i)
    if (notes[i].fn.load(std::memory_order_relaxed) == fn) { hit = notes + i; break; }
  if (hit == nullptr) {
    static std::mutex m;
    std::lock_guard<std::mutex> lock(m);
    const int n = count.load(std::memory_order_acquire);
    for (int i = 0; i < n; ++i)
      if (notes[i].fn.load(std::memory_order_relaxed) == fn) { hit = notes + i; break; }
    if (hit == nullptr) {
      if (n >= MAX_LAUNCH_NOTES) return;
      hit = notes + n;
      hit->fn.store(fn, std::memory_order_relaxed);
      count.store(n + 1, std::memory_order_release);
    }
  }
  hit->launches.fetch_add(1, std::memory_order_relaxed);
  long long prev = hit->max_dynamic_smem.load(std::memory_order_relaxed);
  while (prev < (long long)dynamic_smem &&
         !hit->max_dynamic_smem.compare_exchange_weak(prev, (long long)dynamic_smem)) {
  }
}

}  // namespace repro

#define REPRO_NOTE_LAUNCH(kernel, dynamic_smem) \
  ::repro::note_launch(reinterpret_cast<const void*>(kernel), (size_t)(dynamic_smem))

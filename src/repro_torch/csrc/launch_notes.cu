// The kernels a program launched, as the launch sites noted them
// (common.cuh REPRO_NOTE_LAUNCH), with what cudaFuncGetAttributes says of
// each: the device side of the port's kernel_budget check
// (repro_torch/analysis/checks.py), which holds every launched kernel to
// its declared register, local-memory and shared-memory budget
// (repro_torch/kernels/budgets.py).
#include <string.h>

#include "common.cuh"

// index < 0: forget the launches noted so far (the kernels stay known, with
// no launch); returns 0. index >= 0: returns the number of kernels launched
// since (rows), and, for index < rows, fills attrs (5 int64) with row
// index's numRegs, localSizeBytes, sharedSizeBytes (static), the largest
// dynamic shared memory its launches asked for and its launches, and name
// (name_len bytes, NUL terminated) with its mangled name (empty before CUDA 12.3, which has no
// cudaFuncGetName). A negative return is a CUDA error's code, negated.
extern "C" int repro_kernel_launches(int index, void* attrs, char* name, int name_len) {
  repro::LaunchNote* notes = repro::launch_notes();
  const int n = repro::launch_note_count().load(std::memory_order_acquire);
  if (index < 0) {
    for (int i = 0; i < n; ++i) {
      notes[i].launches.store(0, std::memory_order_relaxed);
      notes[i].max_dynamic_smem.store(0, std::memory_order_relaxed);
    }
    return 0;
  }
  int rows = 0;
  repro::LaunchNote* row = nullptr;
  for (int i = 0; i < n; ++i) {
    if (notes[i].launches.load(std::memory_order_relaxed) == 0) continue;
    if (rows == index) row = notes + i;
    ++rows;
  }
  if (row == nullptr) return rows;
  const void* fn = row->fn.load(std::memory_order_relaxed);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return -(int)err;
  long long* out = static_cast<long long*>(attrs);
  out[0] = a.numRegs;
  out[1] = (long long)a.localSizeBytes;
  out[2] = (long long)a.sharedSizeBytes;
  out[3] = row->max_dynamic_smem.load(std::memory_order_relaxed);
  out[4] = row->launches.load(std::memory_order_relaxed);
  if (name != nullptr && name_len > 0) {
    name[0] = '\0';
#if CUDART_VERSION >= 12030
    const char* mangled = nullptr;
    if (cudaFuncGetName(&mangled, fn) == cudaSuccess && mangled != nullptr) {
      strncpy(name, mangled, (size_t)name_len - 1);
      name[name_len - 1] = '\0';
    }
#endif
  }
  return rows;
}

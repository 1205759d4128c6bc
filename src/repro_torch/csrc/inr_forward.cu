// The INR inference kernel's C entries and its float32 instantiations (the
// kernel and its design: inr_forward.cuh; the bf16 instantiations:
// inr_forward_bf16.cu).
#include "inr_forward.cuh"

namespace repro {
namespace inr {

cudaError_t dispatch_f32(int W, int F, int design, const Args& a) {
  return dispatch<float>(W, F, design, a);
}

}  // namespace inr
}  // namespace repro

namespace {

using namespace repro::inr;

template <typename T, int W>
Layout layout_w(int F, const int* res, int L, long long T_size, int n_hidden,
                long long force) {
  switch (F) {
    case 1: return plan_layout<T, W, 1>(res, L, T_size, n_hidden, force);
    case 2: return plan_layout<T, W, 2>(res, L, T_size, n_hidden, force);
    case 4: return plan_layout<T, W, 4>(res, L, T_size, n_hidden, force);
    default: return plan_layout<T, W, 8>(res, L, T_size, n_hidden, force);
  }
}

template <typename T>
Layout layout_t(int W, int F, const int* res, int L, long long T_size, int n_hidden,
                long long force, int* threads) {
  *threads = W == 16 ? (F == 8 ? Block<T, 16, 8>::THREADS : Block<T, 16, 4>::THREADS)
           : W == 32 ? Block<T, 32, 4>::THREADS : Block<T, 64, 4>::THREADS;
  return W == 16 ? layout_w<T, 16>(F, res, L, T_size, n_hidden, force)
       : W == 32 ? layout_w<T, 32>(F, res, L, T_size, n_hidden, force)
                 : layout_w<T, 64>(F, res, L, T_size, n_hidden, force);
}

// the main design's layout and its block's threads (F in {1, 2, 4, 8} and
// W in {16, 32, 64} checked by the caller)
Layout host_layout(int is_bf16, int W, int F, const int* res, int L, long long T_size,
                   int n_hidden, long long force, int* threads) {
  return is_bf16 ? layout_t<__nv_bfloat16>(W, F, res, L, T_size, n_hidden, force, threads)
                 : layout_t<float>(W, F, res, L, T_size, n_hidden, force, threads);
}

bool bad_shape(long long B, int L, int F, int W, int n_hidden, int D_out, long long T_size,
               const void* tables) {
  return B > 65535 || L < 1 || L > MAX_LEVELS || n_hidden < 1 || D_out > 8 ||
         T_size < 1 || T_size >= (1LL << 32) || reinterpret_cast<uintptr_t>(tables) % 16 ||
         (F != 1 && F != 2 && F != 4 && F != 8) || (W != 16 && W != 32 && W != 64);
}

int run(int is_bf16, int W, int F, int design, const Args& a) {
  return (int)(is_bf16 ? dispatch_bf16(W, F, design, a) : dispatch_f32(W, F, design, a));
}

}  // namespace

// coords (B,N,3) f32; tables (P,L,T,F), 16-byte aligned; res (L,) i32 in
// HOST memory (the plan is made from it on the host); part (B,) i32; w_in
// (P,L*F,W), w_hid (P,n_hid_slab,W,W) with n_hid_slab = max(n_hidden-1, 1),
// w_out (P,W,D_out) -> out (B,N,D_out);
// tables, weights and out in one type (float32 when is_bf16 = 0, else
// bfloat16). F in {1,2,4,8}, W in {16,32,64}, L <= 32, D_out <= 8,
// 0 <= part[b] < P checked on the host; cudaErrorInvalidValue for shapes
// the kernel does not take (the weights' fragments, the resolutions and
// level offsets, the barrier and one warp's 32-row tile above 227 KB).
extern "C" int repro_inr_forward(const void* coords, const void* tables,
                                 const void* res, const void* part, const void* w_in,
                                 const void* w_hid, const void* w_out, void* out,
                                 long long B, long long N, int L, long long T_size,
                                 int F, int W, int n_hidden, int n_hid_slab,
                                 int D_out, int is_bf16, void* stream) {
  if (B <= 0 || N <= 0 || D_out <= 0) return 0;
  if (bad_shape(B, L, F, W, n_hidden, D_out, T_size, tables)) return (int)cudaErrorInvalidValue;
  // the layout with no level staged (the rule stages only into room left
  // beside every warp's tile) must hold a warp
  int zeros[MAX_LEVELS] = {}, threads = 0;
  if (host_layout(is_bf16, W, F, zeros, L, T_size, n_hidden, 0, &threads).warps < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(coords), tables, static_cast<const int*>(res),
               static_cast<const int*>(part), w_in, w_hid, w_out, out, B, N, L, T_size,
               n_hidden, n_hid_slab, D_out, -1, nullptr, nullptr,
               static_cast<cudaStream_t>(stream)};
  return run(is_bf16, W, F, 0, a);
}

// repro_inr_forward with a choice, for measurements: design 0 the main
// design (force < 0 its plan's rule, else the mask of levels to stage), 1
// the grid yardstick (W = 16, F = 4 or W = 64, F = 8; every level direct);
// clocks null, or (kStages + 1) uint64 zeroed on the device: the clocked
// instantiation of the design (W = 16, F = 4 only) adds its stage counts
// and its warps' summed lifetimes there.
extern "C" int repro_inr_forward_with(const void* coords, const void* tables,
                                      const void* res, const void* part,
                                      const void* w_in, const void* w_hid,
                                      const void* w_out, void* out, long long B,
                                      long long N, int L, long long T_size, int F, int W,
                                      int n_hidden, int n_hid_slab, int D_out,
                                      int is_bf16, int design, long long force,
                                      void* clocks, void* stream) {
  if (B <= 0 || N <= 0 || D_out <= 0) return 0;
  if (bad_shape(B, L, F, W, n_hidden, D_out, T_size, tables) || design < 0 || design > 1 ||
      (design == 1 && force >= 0))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(coords), tables, static_cast<const int*>(res),
               static_cast<const int*>(part), w_in, w_hid, w_out, out, B, N, L, T_size,
               n_hidden, n_hid_slab, D_out, force,
               static_cast<unsigned long long*>(clocks), nullptr,
               static_cast<cudaStream_t>(stream)};
  return run(is_bf16, W, F, design, a);
}

// The main design's layout at these shapes (res in host memory; force as
// repro_inr_forward_with's): out[0..4) = staged mask, warps with a tile,
// shared bytes the layout uses, the block's threads.
extern "C" int repro_inr_forward_plan(const void* res, int L, long long T_size, int F,
                                      int W, int n_hidden, int is_bf16, long long force,
                                      void* out) {
  if (L < 1 || L > MAX_LEVELS || bad_shape(1, L, F, W, n_hidden, 1, 1, nullptr))
    return (int)cudaErrorInvalidValue;
  int threads = 0;
  const Layout lay = host_layout(is_bf16, W, F, static_cast<const int*>(res), L, T_size,
                                 n_hidden, force, &threads);
  long long* o = static_cast<long long*>(out);
  o[0] = lay.staged;
  o[1] = lay.warps;
  o[2] = lay.bytes;
  o[3] = threads;
  return 0;
}

// A design's residency at these shapes (res in host memory; design and
// instantiations as repro_inr_forward_with's, unclocked, the main design by
// its rule): out[0..3) = the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the block's threads and
// the dynamic shared bytes its launch asks for. Launches nothing.
extern "C" int repro_inr_forward_occupancy(const void* res, int L, long long T_size, int F,
                                           int W, int n_hidden, int is_bf16, int design,
                                           void* out) {
  if (bad_shape(1, L, F, W, n_hidden, 1, T_size, nullptr) || design < 0 || design > 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.res = static_cast<const int*>(res);
  a.B = a.N = 1;
  a.L = L;
  a.T_size = T_size;
  a.n_hidden = n_hidden;
  a.force = -1;
  a.occupancy = static_cast<long long*>(out);
  return run(is_bf16, W, F, design, a);
}

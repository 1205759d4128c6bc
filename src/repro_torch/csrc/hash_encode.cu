// Multi-resolution hash encoding: the forward (the 8-corner trilinear gather
// and blend of every level) and its backward (the 8-corner scatter of the
// feature cotangent into the tables' gradient), for a batch of coordinate
// rows against partition-stacked tables.
//
// ---- forward ----
//
// Replaces: src/repro/kernels/hash_encoding/kernel.py, hash_encode_pallas
// (the pallas_call at line 74, body _encode_kernel). Where the TPU kernel pins
// one level's (T, F) table in VMEM and walks a level-major grid of coordinate
// tiles, here every (point, level) pair is one thread, consecutive threads
// consecutive pairs, and the tables are read straight from device memory: a
// PRODUCTION256 partition's tables are 655 KB (8 partitions 5.2 MB), so they
// stay resident in the 50 MB L2, and the coarse levels in L1.
//
// Bound: the byte bound counts the coordinates in and the features out (12
// + 4 L F bytes a point at f32); what sets the pace is the instructions of
// each pair's geometry and 8 corners (2.7G corner rows per serving tick),
// and the hashed levels' rows read from L2. The design reads each corner
// row with one vector load (hash_grid.cuh's corner gather: float4 for 4 f32
// features, 8 bytes for 4 bf16), takes the hash's mod T as a mask and the
// pair's i / L in 32 bits, and keeps the write stream coalesced (thread i
// writes the F values at i * F). Designs measured on the H100 and not kept
// (PERF.md): one point per thread with all its levels (its stores scatter
// 16 bytes across each warp's 2,560, and its levels run one after
// another), shared-memory staging of the small level tables (a warp holds
// pairs of every level, so staged and device gathers diverge; the coarse
// tables sit in L1 anyway), and warps of one level each with the outputs
// through a shared tile (faster at the tick's shapes by a few percent,
// slower on a decode chunk).
//
// Numerics, as the JAX kernel: the level geometry of hash_grid.cuh (lower
// corner clamped, offset not: coordinates of rays that miss the box lie far
// outside [0,1] and must extrapolate the same way; dense or uint32-hashed
// indices). Each corner weight is rounded to the table type, the blend is
// accumulated in float32 and rounded to the table type once at the end.
//
// ---- backward ----
//
// Replaces: src/repro/kernels/hash_encoding/ops.py, _bwd (line 85: jnp, the
// per-level `.at[idx].add` that XLA lowers to a combining scatter; the TPU
// has no pallas_call for it). Each thread recomputes a point's 8 corner
// indices and weights at one level exactly as the forward does and adds
// w * g into the float32 gradient (zeroed by the wrapper).
//
// Bound: the atomic requests it cannot avoid (the 0.016 ms byte bound of
// the training shapes is out of reach). The design cuts the requests and
// their contention:
//   - level-major blocks: one launch per level, grid (point chunks, B), so
//     a block's adds all land in one (partition, level) table;
//   - warp pre-reduction: lanes that hit the same row are summed with
//     __match_any_sync groups before any add (hash_grid.cuh), which takes
//     the coarse dense levels (125 rows at PRODUCTION256: 2.1M adds per
//     partition) off a few hot addresses;
//   - staged levels (the wrapper's per-level flag, from rows x F x 4 B
//     against a shared-memory budget): the level's slab is zeroed in
//     dynamic shared memory, takes the adds as shared atomics, and is
//     flushed once per block with one 16-byte global atomic per nonzero row;
//   - direct levels (slabs above the budget: hashed tables of 2^16 rows and
//     more): each group leader adds its row with one 16-byte atomicAdd.
// Sums are float32, in an order that atomics make run-dependent.
//
// A bfloat16 cotangent (hash_encode_bwd_kernel<__nv_bfloat16>, the bf16
// training policy) is read as one vector load of its F values per (row,
// level), 8 bytes at F = 4, and widened in registers; the corner weights,
// the sums and the gradient stay float32. JAX's _bwd sums in the cotangent's dtype
// (ops.py:101-106); the port sums in float32 and the autograd function
// rounds the table gradient once to the tables' type.
#include "common.cuh"
#include "hash_grid.cuh"

namespace {

template <typename T, int F>
__global__ void hash_encode_fwd_kernel(const float* __restrict__ coords,
                                       const T* __restrict__ tables,
                                       const int* __restrict__ resolutions,
                                       const int* __restrict__ part,
                                       T* __restrict__ out, long long N, int L,
                                       long long T_size) {
  const int b = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  long long n;   // i / L in 32 bits where it fits (a 64-bit division is ~3x
  int l;         // the instructions, and this kernel is bound by them)
  if (N * L <= 0xffffffffLL) {
    const unsigned q = (unsigned)i / (unsigned)L;
    n = q;
    l = (int)((unsigned)i - q * (unsigned)L);
  } else {
    n = i / L;
    l = (int)(i - n * L);
  }
  const float* c = coords + ((long long)b * N + n) * 3;
  const float cc[3] = {__ldg(c), __ldg(c + 1), __ldg(c + 2)};
  const repro::LevelGeom geo = repro::level_geom(cc, __ldg(resolutions + l), T_size);
  float acc[F];
  repro::gather_corners<T, F>(geo, tables + ((long long)__ldg(part + b) * L + l) * T_size * F,
                              acc);
  repro::store_row<T, F>(out + (((long long)b * N + n) * L + l) * F, acc);
}

template <typename T>
cudaError_t launch_fwd(const float* coords, const void* tables, const int* res,
                       const int* part, void* out, long long B, long long N, int L,
                       long long T_size, int F, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((N * L + threads - 1) / threads), (unsigned)B);
  const T* t = static_cast<const T*>(tables);
  T* o = static_cast<T*>(out);
  switch (F) {
    case 1: hash_encode_fwd_kernel<T, 1><<<grid, threads, 0, stream>>>(coords, t, res, part, o, N, L, T_size); break;
    case 2: hash_encode_fwd_kernel<T, 2><<<grid, threads, 0, stream>>>(coords, t, res, part, o, N, L, T_size); break;
    case 4: hash_encode_fwd_kernel<T, 4><<<grid, threads, 0, stream>>>(coords, t, res, part, o, N, L, T_size); break;
    case 8: hash_encode_fwd_kernel<T, 8><<<grid, threads, 0, stream>>>(coords, t, res, part, o, N, L, T_size); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// threads per block: a staged block holds its slab for its whole chunk, so
// it runs more warps against the shared memory it pins
constexpr int BWD_THREADS_STAGED = 1024, BWD_THREADS_DIRECT = 512;

// the backward of one level for a cotangent of type TG: float (the float32
// policy) or __nv_bfloat16 (the bf16 policy; the gradient stays float32)
template <typename TG, int F, bool STAGED>
__global__ void __launch_bounds__(BWD_THREADS_STAGED) hash_encode_bwd_kernel(
    const TG* __restrict__ grad_out, const float* __restrict__ coords,
    const int* __restrict__ part, float* __restrict__ grad_tables, long long N,
    int L, int level, int res, long long T_size, int rows, int ppb) {
  extern __shared__ float slab[];   // rows x F, when STAGED
  const int b = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * ppb;   // this block's points
  const long long n1 = min(N, n0 + ppb);
  float* gt = grad_tables + ((long long)__ldg(part + b) * L + level) * T_size * F;
  if constexpr (STAGED) {
    for (int i = threadIdx.x; i < rows * F; i += blockDim.x) slab[i] = 0.0f;
    __syncthreads();
  }
  // whole block strides, so that every lane of a warp reaches the warp-wide
  // pre-reduction; lanes past the chunk carry no point
  for (long long base = n0; base < n1; base += blockDim.x) {
    const long long n = base + threadIdx.x;
    const bool valid = n < n1;
    float cc[3] = {0.0f, 0.0f, 0.0f}, g[F];
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = 0.0f;
    if (valid) {
      const float* c = coords + ((long long)b * N + n) * 3;
      cc[0] = __ldg(c);
      cc[1] = __ldg(c + 1);
      cc[2] = __ldg(c + 2);
      const TG* gr = grad_out + (((long long)b * N + n) * L + level) * F;
      if constexpr (sizeof(TG) == 4) {
#pragma unroll
        for (int f = 0; f < F; ++f) g[f] = __ldg(gr + f);
      } else {
        repro::load_row<TG, F>(gr, g);
      }
    }
    const repro::LevelGeom geo = repro::level_geom(cc, res, T_size);
    repro::scatter_corners<F, STAGED>(geo, g, valid, STAGED ? slab : gt);
  }
  if constexpr (STAGED) {
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float v[F];
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[f] = slab[r * F + f];
        any |= v[f] != 0.0f;
      }
      if (any) repro::atomic_add_row<F>(gt + (long long)r * F, v);
    }
  }
}

// Points a backward block takes: one per thread on the direct route; a
// staged block flushes its slab once, so it takes about as many points as
// the slab has rows (a power of two in [1,024, 4,096]).
int bwd_points_per_block(long long rows, bool staged) {
  if (!staged) return BWD_THREADS_DIRECT;
  int ppb = 1024;
  while (ppb < rows && ppb < 4096) ppb *= 2;
  return ppb;
}

template <typename TG, int F>
cudaError_t launch_bwd_level(const TG* g, const float* coords,
                             const int* part, float* grad, long long B,
                             long long N, int L, int level, int res,
                             bool staged, long long T_size,
                             cudaStream_t stream) {
  const long long rows = repro::level_rows(res, T_size);
  const int ppb = bwd_points_per_block(rows, staged);
  const dim3 grid((unsigned)((N + ppb - 1) / ppb), (unsigned)B);
  if (staged) {
    const int smem = (int)(rows * F * sizeof(float));
    const auto kern = hash_encode_bwd_kernel<TG, F, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, BWD_THREADS_STAGED, smem, stream>>>(g, coords, part, grad, N, L, level,
                                              res, T_size, (int)rows, ppb);
  } else {
    const auto kern = hash_encode_bwd_kernel<TG, F, false>;
    kern<<<grid, BWD_THREADS_DIRECT, 0, stream>>>(g, coords, part, grad, N, L, level,
                                               res, T_size, 0, ppb);
  }
  return cudaGetLastError();
}

template <typename TG, int F>
cudaError_t launch_bwd(const void* g, const float* coords, const int* res,
                       const int* staged, const int* part, float* grad,
                       long long B, long long N, int L, long long T_size,
                       cudaStream_t stream) {
  for (int l = 0; l < L; ++l) {
    const cudaError_t err = launch_bwd_level<TG, F>(
        static_cast<const TG*>(g), coords, part, grad, B, N, L, l, res[l],
        staged[l] != 0, T_size, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename TG>
cudaError_t launch_bwd_f(const void* g, const float* coords, const int* res,
                         const int* staged, const int* part, float* grad,
                         long long B, long long N, int L, long long T_size, int F,
                         cudaStream_t s) {
  switch (F) {
    case 1: return launch_bwd<TG, 1>(g, coords, res, staged, part, grad, B, N, L, T_size, s);
    case 2: return launch_bwd<TG, 2>(g, coords, res, staged, part, grad, B, N, L, T_size, s);
    case 4: return launch_bwd<TG, 4>(g, coords, res, staged, part, grad, B, N, L, T_size, s);
    case 8: return launch_bwd<TG, 8>(g, coords, res, staged, part, grad, B, N, L, T_size, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// coords (B,N,3) f32; tables (P,L,T,F), 16-byte aligned; resolutions (L,)
// i32; part (B,) i32 -> out (B,N,L,F) in the table type; 0 <= part[b] < P
// is checked on the host.
extern "C" int repro_hash_encode_fwd(const void* coords, const void* tables,
                                     const void* resolutions, const void* part,
                                     void* out, long long B, long long N, int L,
                                     long long T_size, int F, int is_bf16,
                                     void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535 || (reinterpret_cast<uintptr_t>(tables) & 15))
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  const int* r = static_cast<const int*>(resolutions);
  const int* p = static_cast<const int*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16>(c, tables, r, p, out, B, N, L, T_size, F, s)
                       : launch_fwd<float>(c, tables, r, p, out, B, N, L, T_size, F, s));
}

// grad_out (B,N,L,F) f32 (is_bf16 = 0) or bf16 (is_bf16 = 1, 16-byte
// aligned: one vector load per (row, level)); coords (B,N,3) f32;
// resolutions and staged (L,) i32 in HOST memory (the level's resolution;
// nonzero: stage the level's slab in shared memory); part (B,) i32 ->
// grad_tables (P,L,T,F) f32, zeroed by the caller, accumulated into;
// 0 <= part[b] < P is checked on the host. One launch per level.
extern "C" int repro_hash_encode_bwd(const void* grad_out, const void* coords,
                                     const void* resolutions, const void* staged,
                                     const void* part, void* grad_tables,
                                     long long B, long long N, int L,
                                     long long T_size, int F, int is_bf16,
                                     void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535 || (is_bf16 && (reinterpret_cast<uintptr_t>(grad_out) & 15)))
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  const int* r = static_cast<const int*>(resolutions);
  const int* st = static_cast<const int*>(staged);
  const int* p = static_cast<const int*>(part);
  float* gt = static_cast<float*>(grad_tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch_bwd_f<__nv_bfloat16>(grad_out, c, r, st, p, gt, B, N, L, T_size, F, s)
      : launch_bwd_f<float>(grad_out, c, r, st, p, gt, B, N, L, T_size, F, s));
}

// The points per block of each level's backward launch, as
// repro_hash_encode_bwd takes them (resolutions, staged and the result
// (L,) i32 in host memory): for counting the launch's atomic requests.
extern "C" int repro_hash_encode_bwd_points_per_block(const void* resolutions,
                                                      const void* staged, int L,
                                                      long long T_size,
                                                      void* points_per_block) {
  const int* r = static_cast<const int*>(resolutions);
  const int* st = static_cast<const int*>(staged);
  int* out = static_cast<int*>(points_per_block);
  for (int l = 0; l < L; ++l)
    out[l] = bwd_points_per_block(repro::level_rows(r[l], T_size), st[l] != 0);
  return 0;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

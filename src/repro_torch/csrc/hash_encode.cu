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
// tiles, here every (point, level) pair is one thread and the tables are read
// straight from device memory: a PRODUCTION256 partition's tables are 655 KB
// (8 partitions 5.2 MB), so they stay resident in the 50 MB L2 and the
// random 8-corner gathers are served from it.
//
// Bound: bytes. Per (point, level) it reads 12 B of coordinates (shared by
// the L threads of the point, so through L1) and writes F values; the
// arithmetic is ~60 operations against 16 B written. The design keeps the
// write stream coalesced (thread i writes the F values at i * F, consecutive
// threads at consecutive addresses) and never materialises the (N, 8, F)
// corner intermediate. Small dense levels are not staged in shared memory in
// this version.
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
// has no pallas_call for it). One thread per (point, level) recomputes the
// level's 8 corner indices and weights exactly as the forward does and adds
// w * g into the float32 gradient (zeroed by the wrapper) with one atomicAdd
// per (corner, feature): 8 * F per thread.
//
// Bound: the atomics. It reads 12 B of coordinates and 4F B of cotangent per
// (point, level) and does 8F read-modify-writes in L2. Dense levels are the
// hot spots: at PRODUCTION256 the three coarse levels have (res+1)^3 = 125,
// 729 and 4,913 rows, so the adds of 65,536 points per partition land on a
// few hundred to a few thousand addresses and serialise in the L2's atomic
// units. This first version does nothing about that contention (no
// warp-level pre-reduction, no shared-memory staging of dense levels); its
// time against its bound is in PERF.md. Atomic adds in float32 make the sum
// order, and so the last bits, change from run to run.
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
  const long long n = i / L;
  const int l = (int)(i - n * L);
  const float* c = coords + ((long long)b * N + n) * 3;
  const float cc[3] = {__ldg(c), __ldg(c + 1), __ldg(c + 2)};
  const repro::LevelGeom geo = repro::level_geom(cc, __ldg(resolutions + l), T_size);
  const T* tab = tables + ((long long)__ldg(part + b) * L + l) * T_size * F;

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const unsigned idx = repro::corner_index(geo, dx, dy, dz);
        const float ww = repro::round_to<T>(repro::corner_weight(geo, dx, dy, dz));
        const T* row = tab + (long long)idx * F;
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += ww * repro::to_f32(row[f]);
      }
    }
  }
  T* o = out + (((long long)b * N + n) * L + l) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = repro::from_f32<T>(acc[f]);
}

template <typename T>
cudaError_t launch(const float* coords, const void* tables, const int* res,
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

template <int F>
__global__ void hash_encode_bwd_kernel(const float* __restrict__ grad_out,
                                       const float* __restrict__ coords,
                                       const int* __restrict__ resolutions,
                                       const int* __restrict__ part,
                                       float* __restrict__ grad_tables,
                                       long long N, int L, long long T_size) {
  const int b = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L) return;
  const long long n = i / L;
  const int l = (int)(i - n * L);
  const float* c = coords + ((long long)b * N + n) * 3;
  const float cc[3] = {__ldg(c), __ldg(c + 1), __ldg(c + 2)};
  const repro::LevelGeom geo = repro::level_geom(cc, __ldg(resolutions + l), T_size);
  const float* gr = grad_out + (((long long)b * N + n) * L + l) * F;
  float g[F];
#pragma unroll
  for (int f = 0; f < F; ++f) g[f] = __ldg(gr + f);
  float* gt = grad_tables + ((long long)__ldg(part + b) * L + l) * T_size * F;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const unsigned idx = repro::corner_index(geo, dx, dy, dz);
        const float ww = repro::corner_weight(geo, dx, dy, dz);
        float* row = gt + (long long)idx * F;
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(row + f, ww * g[f]);
      }
    }
  }
}

cudaError_t launch_bwd(const float* g, const float* coords, const int* res,
                       const int* part, float* grad, long long B, long long N,
                       int L, long long T_size, int F, cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((N * L + threads - 1) / threads), (unsigned)B);
  switch (F) {
    case 1: hash_encode_bwd_kernel<1><<<grid, threads, 0, stream>>>(g, coords, res, part, grad, N, L, T_size); break;
    case 2: hash_encode_bwd_kernel<2><<<grid, threads, 0, stream>>>(g, coords, res, part, grad, N, L, T_size); break;
    case 4: hash_encode_bwd_kernel<4><<<grid, threads, 0, stream>>>(g, coords, res, part, grad, N, L, T_size); break;
    case 8: hash_encode_bwd_kernel<8><<<grid, threads, 0, stream>>>(g, coords, res, part, grad, N, L, T_size); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// coords (B,N,3) f32; tables (P,L,T,F); resolutions (L,) i32; part (B,) i32
// -> out (B,N,L,F) in the table type; 0 <= part[b] < P is checked on the host.
extern "C" int repro_hash_encode_fwd(const void* coords, const void* tables,
                                     const void* resolutions, const void* part,
                                     void* out, long long B, long long N, int L,
                                     long long T_size, int F, int is_bf16,
                                     void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  const int* r = static_cast<const int*>(resolutions);
  const int* p = static_cast<const int*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(c, tables, r, p, out, B, N, L, T_size, F, s)
                       : launch<float>(c, tables, r, p, out, B, N, L, T_size, F, s));
}

// grad_out (B,N,L,F) f32; coords (B,N,3) f32; resolutions (L,) i32; part (B,)
// i32 -> grad_tables (P,L,T,F) f32, zeroed by the caller, accumulated into;
// 0 <= part[b] < P is checked on the host.
extern "C" int repro_hash_encode_bwd(const void* grad_out, const void* coords,
                                     const void* resolutions, const void* part,
                                     void* grad_tables, long long B, long long N,
                                     int L, long long T_size, int F,
                                     void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch_bwd(static_cast<const float*>(grad_out),
                         static_cast<const float*>(coords),
                         static_cast<const int*>(resolutions),
                         static_cast<const int*>(part),
                         static_cast<float*>(grad_tables), B, N, L, T_size, F,
                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

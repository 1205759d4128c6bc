// Multi-resolution hash encoding, forward: the 8-corner trilinear gather and
// blend of every level, for a batch of coordinate rows against
// partition-stacked tables.
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
// Numerics, as the JAX kernel: the lower corner is clamped to [0, res-1] and
// the fractional offset w is NOT clamped (coordinates of rays that miss the
// box lie far outside [0,1] and must extrapolate the same way); dense levels
// ((res+1)^3 <= T) index injectively, the others hash with uint32 wraparound
// products by 1, 2654435761 and 805459861, both taken mod T. Each corner
// weight is rounded to the table type, the blend is accumulated in float32
// and rounded to the table type once at the end.
#include "common.cuh"

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
  const int res = __ldg(resolutions + l);
  const float rf = (float)res;
  const float hi = (float)(res > 1 ? res - 1 : 0);
  const float* c = coords + ((long long)b * N + n) * 3;

  float w[3];
  unsigned lo[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __ldg(c + d) * rf;
    const float lo_f = fminf(fmaxf(floorf(pos), 0.0f), hi);
    w[d] = pos - lo_f;
    lo[d] = (unsigned)lo_f;
  }
  const long long r1 = (long long)res + 1;
  const bool dense = r1 * r1 * r1 <= T_size;
  const unsigned rp1 = (unsigned)r1;
  const unsigned tsz = (unsigned)T_size;
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
        const unsigned cx = lo[0] + dx, cy = lo[1] + dy, cz = lo[2] + dz;
        const unsigned idx =
            dense ? cx + rp1 * (cy + rp1 * cz)
                  : ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) % tsz;
        const float ww = repro::round_to<T>((dx ? w[0] : 1.0f - w[0]) *
                                            (dy ? w[1] : 1.0f - w[1]) *
                                            (dz ? w[2] : 1.0f - w[2]));
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

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Front-to-back over-operator compositing of ray samples.
//
// Replaces: src/repro/kernels/composite/kernel.py, composite_pallas (the
// pallas_call at line 57, body _composite_kernel). The TPU kernel walks a
// (ray tiles, sample tiles) grid in order and carries (color, transmittance)
// across sample tiles in VMEM scratch. A GPU runs blocks in no order, so the
// sample loop moves inside the block: one thread owns one ray and carries its
// (color, transmittance) in float32 registers over all S samples.
//
// Bound: bytes. Each sample is read once (16 B in float32) and does 7
// flops; one (R, 4) row is written per ray. A ray's samples are contiguous
// (S x 16 B), so one-thread-per-ray loads would stride the warp across S x 16
// B; instead the block stages CHUNK samples of its RAYS rays at a time in
// shared memory with coalesced loads (consecutive threads, consecutive
// addresses), then each thread composites its own ray from shared memory.
//
// Numerics, as the JAX kernel: color += (T * a) * rgb, T *= (1 - a), in
// float32 whatever the input type, cast to the input type at the end, with
// alpha = 1 - T. No early exit: the reference has none, and stopping at a
// small T would change the result.
#include "common.cuh"

namespace {

constexpr int RAYS = 128;   // rays (threads) per block
constexpr int CHUNK = 8;    // samples staged per ray per step
constexpr int ROW = CHUNK * 4 + 1;  // +1 float pads shared-memory banks apart

template <typename T>
__global__ void composite_kernel(const T* __restrict__ rgba, T* __restrict__ out,
                                 long long R, int S) {
  __shared__ float tile[RAYS * ROW];
  const long long r0 = (long long)blockIdx.x * RAYS;
  const long long r = r0 + threadIdx.x;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, trans = 1.0f;
  for (int s0 = 0; s0 < S; s0 += CHUNK) {
    const int cs = min(CHUNK, S - s0);
    const int row_elems = cs * 4;
    for (int i = threadIdx.x; i < RAYS * row_elems; i += RAYS) {
      const int ray = i / row_elems, e = i - ray * row_elems;
      const long long rr = r0 + ray;
      if (rr < R) tile[ray * ROW + e] = repro::to_f32(rgba[(rr * S + s0) * 4 + e]);
    }
    __syncthreads();
    if (r < R) {
      const float* t = tile + threadIdx.x * ROW;
      for (int j = 0; j < cs; ++j) {
        const float a = t[4 * j + 3];
        const float ta = trans * a;
        cr += ta * t[4 * j + 0];
        cg += ta * t[4 * j + 1];
        cb += ta * t[4 * j + 2];
        trans = trans * (1.0f - a);
      }
    }
    __syncthreads();
  }
  if (r < R) {
    T* o = out + r * 4;
    o[0] = repro::from_f32<T>(cr);
    o[1] = repro::from_f32<T>(cg);
    o[2] = repro::from_f32<T>(cb);
    o[3] = repro::from_f32<T>(1.0f - trans);
  }
}

}  // namespace

// rgba (R,S,4) front-to-back -> out (R,4), both in one type.
extern "C" int repro_composite(const void* rgba, void* out, long long R, int S,
                               int is_bf16, void* stream) {
  if (R <= 0) return 0;
  const dim3 grid((unsigned)((R + RAYS - 1) / RAYS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    REPRO_NOTE_LAUNCH(composite_kernel<__nv_bfloat16>, 0);
    composite_kernel<__nv_bfloat16><<<grid, RAYS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(rgba), static_cast<__nv_bfloat16*>(out), R, S);
  } else {
    REPRO_NOTE_LAUNCH(composite_kernel<float>, 0);
    composite_kernel<float><<<grid, RAYS, 0, s>>>(
        static_cast<const float*>(rgba), static_cast<float*>(out), R, S);
  }
  return (int)cudaGetLastError();
}

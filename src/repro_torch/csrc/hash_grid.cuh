// The multi-resolution hash grid's per-level geometry, shared by the hash
// encode kernels (forward and backward) and the fused train step: the
// clamped lower corner and the UNclamped fractional offset of a coordinate,
// the dense-or-hashed index of each of the 8 corners, and its trilinear
// weight. The arithmetic is the JAX package's (hash_encoding/ref.py): the
// lower corner is clamped to [0, res-1], the offset w = pos - lo is not
// (coordinates outside [0,1] extrapolate); a level is dense when
// (res+1)^3 <= T, computed in 64 bits (the Pallas train-step kernel's int32
// product would wrap for res >= 1291); hashed levels multiply by 1,
// 2654435761 and 805459861 with uint32 wraparound and take the xor mod T.
//
// The corner gather of the forward (the hash-encode forward and the train
// step's encode) is here: each corner's row is read as one vector load
// through the read-only path (float4 for 4 float32 features, two for 8,
// float2 for 2; 8 bytes for 4 bfloat16 features, 16 for 8) and blended in
// float32 with the weight rounded to the table type.
//
// So is the corner scatter of the backward (the table-gradient adds):
// lanes of a warp that hit the same row are summed first (__match_any_sync
// groups, a tree of shuffles inside each group), and each group's leader
// adds the row once, into a shared-memory slab (one 128-bit compare-and-
// swap per 4 features: the card has no shared float atomic add) or straight
// into the device gradient (one 16-byte atomicAdd per row of 4 features:
// float2 for F=2, two float4 for F=8, a scalar for F=1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {

struct LevelGeom {
  unsigned lo[3];
  float w[3];
  bool dense;
  unsigned rp1;   // res + 1 (dense row length)
  unsigned tsz;   // T
  unsigned tmask; // T - 1 when T is a power of two (mod T is a mask), else 0
};

// a level is dense when its (res+1)^3 grid points fit the table's T rows
__host__ __device__ __forceinline__ bool level_dense(int res, long long T) {
  const long long r1 = (long long)res + 1;
  return r1 * r1 * r1 <= T;
}

// the rows of its table a level uses: (res+1)^3 when dense, else T
__host__ __device__ __forceinline__ long long level_rows(int res, long long T) {
  const long long r1 = (long long)res + 1;
  return level_dense(res, T) ? r1 * r1 * r1 : T;
}

__device__ __forceinline__ LevelGeom level_geom(const float c[3], int res,
                                                long long T) {
  LevelGeom g;
  const float rf = (float)res;
  const float hi = (float)(res > 1 ? res - 1 : 0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = c[d] * rf;
    const float lo_f = fminf(fmaxf(floorf(pos), 0.0f), hi);
    g.w[d] = pos - lo_f;
    g.lo[d] = (unsigned)lo_f;
  }
  g.dense = level_dense(res, T);
  g.rp1 = (unsigned)(res + 1);
  g.tsz = (unsigned)T;
  g.tmask = (T & (T - 1)) == 0 ? (unsigned)(T - 1) : 0u;
  return g;
}

// index of corner (dx, dy, dz) in the level's table of T rows (the hash's
// mod T taken as a mask when T is a power of two: the same number, without
// the ~20 instructions of a division by a runtime value)
__device__ __forceinline__ unsigned corner_index(const LevelGeom& g, int dx,
                                                 int dy, int dz) {
  const unsigned cx = g.lo[0] + dx, cy = g.lo[1] + dy, cz = g.lo[2] + dz;
  if (g.dense) return cx + g.rp1 * (cy + g.rp1 * cz);
  const unsigned h = (cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u);
  return g.tmask ? h & g.tmask : h % g.tsz;
}

// trilinear weight of corner (dx, dy, dz), the product taken left to right
__device__ __forceinline__ float corner_weight(const LevelGeom& g, int dx,
                                               int dy, int dz) {
  return (dx ? g.w[0] : 1.0f - g.w[0]) * (dy ? g.w[1] : 1.0f - g.w[1]) *
         (dz ? g.w[2] : 1.0f - g.w[2]);
}

// One table row of F values in T (float or bfloat16), as float32: one
// vector load of F * sizeof(T) bytes (a bf16 row of 1 is 2 bytes) through
// the read-only path. The row must be aligned to its size (16 bytes at
// most).
template <typename T, int F>
__device__ __forceinline__ void load_row(const T* row, float (&v)[F]) {
  constexpr int BYTES = F * (int)sizeof(T);
  if constexpr (BYTES == 2) {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
    v[0] = __uint_as_float((unsigned)__ldg(p) << 16);
    return;
  } else {
    constexpr int WORDS = BYTES / 4;
    unsigned u[WORDS];
    if constexpr (WORDS == 1) {
      const unsigned* p = reinterpret_cast<const unsigned*>(row);
      u[0] = __ldg(p);
    } else if constexpr (WORDS == 2) {
      const uint2* p = reinterpret_cast<const uint2*>(row);
      const uint2 q = __ldg(p);
      u[0] = q.x; u[1] = q.y;
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k) {
        const uint4 q = __ldg(p + k);
        u[4 * k] = q.x; u[4 * k + 1] = q.y; u[4 * k + 2] = q.z; u[4 * k + 3] = q.w;
      }
    }
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      if constexpr (sizeof(T) == 4) {
        v[k] = __uint_as_float(u[k]);
      } else {   // two bfloat16 per word, the lower address in the low half
        v[2 * k] = __uint_as_float(u[k] << 16);
        v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
      }
    }
  }
}

// row[0..F) = v rounded to T, as one vector store
template <typename T, int F>
__device__ __forceinline__ void store_row(T* row, const float (&v)[F]) {
  constexpr int BYTES = F * (int)sizeof(T);
  if constexpr (BYTES == 2) {
    row[0] = from_f32<T>(v[0]);
  } else {
    constexpr int WORDS = BYTES / 4;
    unsigned u[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      if constexpr (sizeof(T) == 4) {
        u[k] = __float_as_uint(v[k]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        u[k] = *reinterpret_cast<const unsigned*>(&h);
      }
    }
    if constexpr (WORDS == 1) {
      *reinterpret_cast<unsigned*>(row) = u[0];
    } else if constexpr (WORDS == 2) {
      *reinterpret_cast<uint2*>(row) = make_uint2(u[0], u[1]);
    } else {
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k)
        reinterpret_cast<uint4*>(row)[k] =
            make_uint4(u[4 * k], u[4 * k + 1], u[4 * k + 2], u[4 * k + 3]);
    }
  }
}

// The forward's blend at one level: acc = sum over the 8 corners of
// weight x row of the level's (T, F) table, in float32, each weight rounded
// to the table type.
template <typename T, int F>
__device__ __forceinline__ void gather_corners(const LevelGeom& g, const T* table,
                                               float (&acc)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float ww = round_to<T>(corner_weight(g, dx, dy, dz));
        float v[F];
        load_row<T, F>(table + (size_t)corner_index(g, dx, dy, dz) * F, v);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += ww * v[f];
      }
    }
  }
}

// Sum, over the lanes of a warp that hold the same key, their F values
// into the group's lowest lane (its leader), which gets true back. Every
// lane of the warp calls it. A tree over each group: round k adds the
// partial sum of the group member 2^k ranks up; a warp whose keys are all
// distinct runs no round.
template <int F>
__device__ __forceinline__ bool warp_reduce_peers(unsigned key, float (&v)[F]) {
  const unsigned lane = threadIdx.x & 31;
  unsigned peers = __match_any_sync(0xffffffffu, key);
  const bool leader = (unsigned)(__ffs(peers) - 1) == lane;
  unsigned rank = __popc(peers & ((1u << lane) - 1));   // rank in the group
  peers &= 0xfffffffeu << lane;                        // members above me
  while (__any_sync(0xffffffffu, peers)) {
    const int next = __ffs(peers);                     // 1 + the next member
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float t = __shfl_sync(0xffffffffu, v[f], next ? next - 1 : lane);
      if (next) v[f] += t;
    }
    // members of odd rank were just summed into their lower neighbour
    peers &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
  return leader;
}

// row[0..F) += v, one vector atomic for 2, 4 and 8 features (global memory)
template <int F>
__device__ __forceinline__ void atomic_add_row(float* row, const float (&v)[F]) {
  if constexpr (F == 8) {
    atomicAdd(reinterpret_cast<float4*>(row), make_float4(v[0], v[1], v[2], v[3]));
    atomicAdd(reinterpret_cast<float4*>(row) + 1, make_float4(v[4], v[5], v[6], v[7]));
  } else if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(row), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(row), make_float2(v[0], v[1]));
  } else {
    atomicAdd(row, v[0]);
  }
}

// p[0..4) += (a, b, c, d) in SHARED memory as one 128-bit compare-and-swap
// loop (sm_90): the card has no shared-memory float atomic add, and
// atomicAdd on a shared float is a compare-and-swap loop of its own, so one
// loop per 4 features instead of 4. p must be 16-byte aligned.
__device__ __forceinline__ void shared_add4(float* p, float a, float b, float c,
                                            float d) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  float4 old = *reinterpret_cast<const float4*>(p);   // a torn read fails one CAS
  while (true) {
    const unsigned long long olo =
        ((unsigned long long)__float_as_uint(old.y) << 32) | __float_as_uint(old.x);
    const unsigned long long ohi =
        ((unsigned long long)__float_as_uint(old.w) << 32) | __float_as_uint(old.z);
    const unsigned long long nlo =
        ((unsigned long long)__float_as_uint(old.y + b) << 32) | __float_as_uint(old.x + a);
    const unsigned long long nhi =
        ((unsigned long long)__float_as_uint(old.w + d) << 32) | __float_as_uint(old.z + c);
    unsigned long long rlo, rhi;
    asm volatile(
        "{\n.reg .b128 cmp, swp, got;\n"
        "mov.b128 cmp, {%2, %3};\n"
        "mov.b128 swp, {%4, %5};\n"
        "atom.shared::cta.cas.b128 got, [%6], cmp, swp;\n"
        "mov.b128 {%0, %1}, got;\n}\n"
        : "=l"(rlo), "=l"(rhi)
        : "l"(olo), "l"(ohi), "l"(nlo), "l"(nhi), "r"(addr)
        : "memory");
    if (rlo == olo && rhi == ohi) return;
    old = make_float4(__uint_as_float((unsigned)rlo), __uint_as_float((unsigned)(rlo >> 32)),
                      __uint_as_float((unsigned)rhi), __uint_as_float((unsigned)(rhi >> 32)));
  }
}

// p[0..2) += (a, b) in SHARED memory as one 64-bit compare-and-swap loop
__device__ __forceinline__ void shared_add2(float* p, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(q);
  while (true) {
    const unsigned long long nw =
        ((unsigned long long)__float_as_uint(__uint_as_float((unsigned)(old >> 32)) + b) << 32) |
        __float_as_uint(__uint_as_float((unsigned)old) + a);
    const unsigned long long got = atomicCAS(q, old, nw);
    if (got == old) return;
    old = got;
  }
}

// row[0..F) += v in shared memory
template <int F>
__device__ __forceinline__ void shared_add_row(float* row, const float (&v)[F]) {
  if constexpr (F >= 4) {
#pragma unroll
    for (int q = 0; q < F; q += 4)
      shared_add4(row + q, v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else if constexpr (F == 2) {
    shared_add2(row, v[0], v[1]);
  } else {
    atomicAdd(row, v[0]);
  }
}

// Scatter corner_weight * g into the level's 8 corner rows of `dst` (rows
// of F floats): a shared-memory slab when SHARED, else the level's device
// gradient. Each product is taken in float32 as the forward's weight times
// the cotangent; same-row lanes are summed before the add. Every lane of
// the warp calls it; a lane without a point passes valid = false (its key
// 0xffffffff is no row: T < 2^32).
template <int F, bool SHARED>
__device__ __forceinline__ void scatter_corners(const LevelGeom& geo,
                                                const float (&g)[F], bool valid,
                                                float* dst) {
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const unsigned idx = valid ? corner_index(geo, dx, dy, dz) : 0xffffffffu;
        const float w = corner_weight(geo, dx, dy, dz);
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = w * g[f];
        if (warp_reduce_peers<F>(idx, v) && valid) {
          float* row = dst + (size_t)idx * F;
          if constexpr (SHARED) {
            shared_add_row<F>(row, v);
          } else {
            atomic_add_row<F>(row, v);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The deterministic route's table gradient (train_step.cuh, DET): every
// contribution is added as an int64 fixed-point number, value * 2^FX_SHIFT
// rounded to the nearest integer. Integer addition is associative, so the
// sum of a table entry does not depend on the order in which warps and
// blocks reach it. It is converted to float32 once, by adamw.cu.
//
// The bound. A contribution is w * g: a trilinear weight (|w| <= 1 for a
// coordinate in [0,1]) times the feature cotangent of one sample. The L1
// loss's cotangent is +-1 / (N * D_out) a row, and the MLP backward carries
// it to a feature with a gain of at most the product of its layers' norms,
// so N * |w * g| <= that gain. The kernel requires N * |w * g| <= FX_BOUND
// (2^12) of every contribution. An entry takes at most 8 N contributions
// (every corner of every sample), each rounded once after the warp's
// pre-reduction, so |sum| <= 8 N (FX_BOUND / N) 2^47 + 4 N = 2^62 + 4 N,
// inside int64. A contribution past the bound is not added silently: it sets
// bit FX_OVER of the partition's flag (a non-finite one sets FX_NONFINITE),
// adamw.cu then gives the partition NaN gradients and a NaN loss, and the
// trainer raises on FX_OVER. The quantum 2^-47 (7.1e-15) is ~1e-9 of a
// typical contribution (1/N = 1.5e-5 at N = 65,536): the fixed-point sum is
// closer to the exact sum than a float32 one.
constexpr int FX_SHIFT = 47;
constexpr float FX_BOUND = 4096.0f;
constexpr unsigned FX_NONFINITE = 1u, FX_OVER = 2u;

// row[0..F) += v as F 64-bit integer atomics of the fixed-point values (the
// card has no vector integer atomic: a row of 4 features is 4 requests)
template <int F>
__device__ __forceinline__ void atomic_add_row_fx(unsigned long long* row,
                                                  const float (&v)[F]) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const long long q = __float2ll_rn(v[f] * 140737488355328.0f);   // 2^47
    atomicAdd(row + f, (unsigned long long)q);   // two's complement: wraps back
  }
}

// scatter_corners for the deterministic route: the same products and the
// same warp pre-reduction (its tree depends only on the warp's rows, not on
// timing), then the fixed-point adds. A valid lane whose contribution is
// past vmax = FX_BOUND / N, or not finite, ORs its flag bit into `bad`.
template <int F>
__device__ __forceinline__ void scatter_corners_fx(const LevelGeom& geo,
                                                   const float (&g)[F], bool valid,
                                                   unsigned long long* dst,
                                                   float vmax, unsigned& bad) {
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const unsigned idx = valid ? corner_index(geo, dx, dy, dz) : 0xffffffffu;
        const float w = corner_weight(geo, dx, dy, dz);
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          v[f] = w * g[f];
          const float m = fabsf(v[f]);
          if (valid && !(m <= vmax)) bad |= isfinite(m) ? FX_OVER : FX_NONFINITE;
        }
        if (warp_reduce_peers<F>(idx, v) && valid)
          atomic_add_row_fx<F>(dst + (size_t)idx * F, v);
      }
    }
  }
}

}  // namespace repro

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
#pragma once

#include <cuda_runtime.h>

namespace repro {

struct LevelGeom {
  unsigned lo[3];
  float w[3];
  bool dense;
  unsigned rp1;   // res + 1 (dense row length)
  unsigned tsz;   // T
};

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
  const long long r1 = (long long)res + 1;
  g.dense = r1 * r1 * r1 <= T;
  g.rp1 = (unsigned)r1;
  g.tsz = (unsigned)T;
  return g;
}

// index of corner (dx, dy, dz) in the level's table of T rows
__device__ __forceinline__ unsigned corner_index(const LevelGeom& g, int dx,
                                                 int dy, int dz) {
  const unsigned cx = g.lo[0] + dx, cy = g.lo[1] + dy, cz = g.lo[2] + dz;
  return g.dense ? cx + g.rp1 * (cy + g.rp1 * cz)
                 : ((cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u)) % g.tsz;
}

// trilinear weight of corner (dx, dy, dz), the product taken left to right
__device__ __forceinline__ float corner_weight(const LevelGeom& g, int dx,
                                               int dy, int dz) {
  return (dx ? g.w[0] : 1.0f - g.w[0]) * (dy ? g.w[1] : 1.0f - g.w[1]) *
         (dz ? g.w[2] : 1.0f - g.w[2]);
}

}  // namespace repro

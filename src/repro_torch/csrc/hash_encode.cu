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
// The deterministic route (torch.use_deterministic_algorithms(True): the
// wrapper calls repro_hash_encode_bwd_fx; the train step's route calls
// fx_scatter too): the same per-level launches and the same warp
// pre-reduction (its tree depends only on the rows a warp holds), but each
// group leader adds its row as int64 fixed point (hash_grid.cuh's scatter
// layer: 2^-47 quanta, the bound M |w g| <= FX_BOUND with M the points of a
// partition, and the partition's flag bits past it). Bound: the byte bound
// is out of reach again; what sets the pace is the 64-bit adds (F requests a
// row: the card has no vector integer atomic) and where they land. Each
// level's plan (fx_scatter.cuh, made on the host) keeps them off device
// memory as far as shared memory holds its int64 slab (rows x F x 8 bytes):
// 's' in one block (PRODUCTION256's three dense levels), 'c' split across a
// cluster of 2, 4 or 8 blocks through distributed shared memory (its two
// hashed levels of 256 KiB: a cluster of 2), each slab flushed once with
// one 64-bit atomic a nonzero entry; 'd' direct where no cluster of 8 holds
// the slab (PRODUCTION's 2 MiB hashed levels). The yardstick,
// hash_encode_bwd_fx_block_kernel, stages only what one block holds and
// sends the rest direct, 4 x 8-byte atomics to device memory a corner row
// (chip_smoke.py holds the layer to its bits and its time). Integer adds
// are associative, so the sum depends neither on the order in which
// threads and blocks reach a row nor on the plan or the grid (which depends
// on N and the level's rows alone) nor on the partitions stacked beside it.
// A last launch converts each entry once to float32 through float64
// (adamw.cu's from_fixed, det_grads_to_float's arithmetic), NaN for a
// flagged partition.
//
// A bfloat16 cotangent (hash_encode_bwd_kernel<__nv_bfloat16>, the bf16
// training policy) is read as one vector load of its F values per (row,
// level), 8 bytes at F = 4, and widened in registers; the corner weights,
// the sums and the gradient stay float32. JAX's _bwd sums in the cotangent's dtype
// (ops.py:101-106); the port sums in float32 and the autograd function
// rounds the table gradient once to the tables' type.
#include <cooperative_groups.h>

#include "common.cuh"
#include "fx_scatter.cuh"
#include "hash_grid.cuh"

namespace cg = cooperative_groups;

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
    case 1: REPRO_NOTE_LAUNCH((hash_encode_fwd_kernel<T, 1>), 0); hash_encode_fwd_kernel<T, 1><<<grid, threads, 0, stream>>>(coords, t, res, part, o, N, L, T_size); break;
    case 2: REPRO_NOTE_LAUNCH((hash_encode_fwd_kernel<T, 2>), 0); hash_encode_fwd_kernel<T, 2><<<grid, threads, 0, stream>>>(coords, t, res, part, o, N, L, T_size); break;
    case 4: REPRO_NOTE_LAUNCH((hash_encode_fwd_kernel<T, 4>), 0); hash_encode_fwd_kernel<T, 4><<<grid, threads, 0, stream>>>(coords, t, res, part, o, N, L, T_size); break;
    case 8: REPRO_NOTE_LAUNCH((hash_encode_fwd_kernel<T, 8>), 0); hash_encode_fwd_kernel<T, 8><<<grid, threads, 0, stream>>>(coords, t, res, part, o, N, L, T_size); break;
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

// The deterministic route's backward of one level on hash_grid.cuh's
// fixed-point scatter layer, the level's plan letter SITE (fx_scatter.cuh):
// 's' sums the block's points into its rows x F int64 slab, 'c' into the
// cluster's slab (block k holds rows [k span, (k+1) span), added to through
// distributed shared memory), each then flushed once with one 64-bit atomic a
// nonzero entry; 'd' adds straight into grad_fx (P,L,T,F). Each warp's flag
// bits are ORed into its partition's flags entry. part null: row b is
// partition b (the train step's split).
template <typename TG, int F, char SITE>
__global__ void __launch_bounds__(BWD_THREADS_STAGED, 1) hash_encode_bwd_fx_kernel(
    const TG* __restrict__ grad_out, const float* __restrict__ coords,
    const int* __restrict__ part, unsigned long long* __restrict__ grad_fx,
    unsigned long long* __restrict__ flags, long long N, int L, int level, int res,
    long long T_size, int rows, int span, int ppb, float vmax) {
  extern __shared__ unsigned long long fx_slab[];   // span x F, unless 'd'
  const int b = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * ppb;   // this block's points
  const long long n1 = min(N, n0 + ppb);              // (none in a padding block)
  const long long p = part ? __ldg(part + b) : b;
  unsigned long long* gt = grad_fx + (p * L + level) * T_size * F;
  unsigned rank = 0;
  if constexpr (SITE != 'd') {
    for (int i = threadIdx.x; i < span * F; i += blockDim.x) fx_slab[i] = 0ull;
    if constexpr (SITE == 'c') {
      rank = cg::this_cluster().block_rank();
      cg::this_cluster().sync();   // every slab of the cluster zeroed
    } else {
      __syncthreads();
    }
  }
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(fx_slab);
  unsigned bad = 0;
  // whole block strides, so that every lane of a warp reaches the warp-wide
  // pre-reduction; lanes past the chunk carry no point. A block's points
  // start at a multiple of 32, so lane i of a warp holds point 32k + i, as
  // in the train step's tiles
  for (long long n_base = n0; n_base < n1; n_base += blockDim.x) {
    const long long n = n_base + threadIdx.x;
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
    if constexpr (SITE == 'd') {
      repro::scatter_corners_fx<F>(geo, g, valid, repro::FxAtomic{gt}, vmax, bad);
    } else if constexpr (SITE == 's') {
      repro::scatter_corners_fx<F>(geo, g, valid, repro::FxSlab{base}, vmax, bad);
    } else {
      repro::scatter_corners_fx<F>(geo, g, valid, repro::FxCluster{base, (unsigned)span},
                                   vmax, bad);
    }
  }
  if constexpr (SITE != 'd') {
    if constexpr (SITE == 'c') {
      cg::this_cluster().sync();   // every add of the cluster landed
    } else {
      __syncthreads();
    }
    // this block's rows: [rank span, min(rows, (rank+1) span))
    const long long first = (long long)rank * span;
    const int n_ent = (int)(min((long long)span, (long long)rows - first) * F);
    unsigned long long* dst = gt + first * F;
    for (int i = threadIdx.x; i < n_ent; i += blockDim.x) {
      const unsigned long long v = fx_slab[i];
      if (v) atomicAdd(dst + i, v);
    }
  }
  bad = __reduce_or_sync(0xffffffffu, bad);
  if (bad && (threadIdx.x & 31) == 0) atomicOr(flags + p, (unsigned long long)bad);
}

// The yardstick of hash_encode_bwd_fx_kernel (F = 4, launched only by
// repro_hash_encode_bwd_fx_block): the corner adds as int64 fixed point,
// 64-bit atomicAdds into the level's rows x F slab in shared memory when
// STAGED (compare-and-swap loops: hash_grid.cuh), flushed once a block with
// one 64-bit atomic a nonzero entry, or straight into grad_fx (P,L,T,F);
// each warp's flag bits ORed into its partition's flags entry.
template <typename TG, int F, bool STAGED>
__global__ void __launch_bounds__(BWD_THREADS_STAGED, 1) hash_encode_bwd_fx_block_kernel(
    const TG* __restrict__ grad_out, const float* __restrict__ coords,
    const int* __restrict__ part, unsigned long long* __restrict__ grad_fx,
    unsigned long long* __restrict__ flags, long long N, int L, int level, int res,
    long long T_size, int rows, int ppb, float vmax) {
  extern __shared__ unsigned long long fx_slab[];   // rows x F, when STAGED
  const int b = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * ppb;   // this block's points
  const long long n1 = min(N, n0 + ppb);
  const long long p = __ldg(part + b);
  unsigned long long* gt = grad_fx + (p * L + level) * T_size * F;
  if constexpr (STAGED) {
    for (int i = threadIdx.x; i < rows * F; i += blockDim.x) fx_slab[i] = 0ull;
    __syncthreads();
  }
  unsigned bad = 0;
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
    repro::scatter_corners_fx<F>(geo, g, valid, repro::FxAtomic{STAGED ? fx_slab : gt},
                                  vmax, bad);
  }
  if constexpr (STAGED) {
    __syncthreads();
    for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
      const unsigned long long v = fx_slab[i];
      if (v) atomicAdd(gt + i, v);
    }
  }
  bad = __reduce_or_sync(0xffffffffu, bad);
  if (bad && (threadIdx.x & 31) == 0) atomicOr(flags + p, (unsigned long long)bad);
}

// grad[i] = grad_fx[i] x 2^-FX_SHIFT through float64, rounded once to
// float32; NaN in every entry of a flagged partition
__global__ void fx_to_float_kernel(const unsigned long long* __restrict__ grad_fx,
                                   const unsigned long long* __restrict__ flags,
                                   float* __restrict__ grad, long long per_part,
                                   long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    grad[i] = flags[i / per_part]
        ? __int_as_float(0x7fffffff)
        : __double2float_rn(__ll2double_rn((long long)grad_fx[i]) *
                            (1.0 / (double)(1LL << repro::FX_SHIFT)));
  }
}

int bwd_points_per_block(long long rows, bool staged);

// The yardstick's launches (F = 4): one a level, staged (the level's int64
// slab in one block's shared memory) where the slab fits FX_STAGE_BUDGET,
// else direct.
template <typename TG>
cudaError_t launch_bwd_fx_block(const void* g, const float* coords, const int* res,
                                const int* part, unsigned long long* grad_fx,
                                unsigned long long* flags, long long B, long long N,
                                int L, long long T_size, float vmax,
                                cudaStream_t stream) {
  constexpr int F = 4;
  const TG* gt = static_cast<const TG*>(g);
  for (int l = 0; l < L; ++l) {
    const long long rows = repro::level_rows(res[l], T_size);
    const bool staged = rows * F * 8 <= repro::FX_STAGE_BUDGET;
    const int ppb = bwd_points_per_block(rows, staged);
    const dim3 grid((unsigned)((N + ppb - 1) / ppb), (unsigned)B);
    if (staged) {
      const int smem = (int)(rows * F * sizeof(unsigned long long));
      const auto kern = hash_encode_bwd_fx_block_kernel<TG, F, true>;
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      REPRO_NOTE_LAUNCH(kern, smem);
      kern<<<grid, BWD_THREADS_STAGED, smem, stream>>>(
          gt, coords, part, grad_fx, flags, N, L, l, res[l], T_size, (int)rows, ppb,
          vmax);
    } else {
      const auto kern = hash_encode_bwd_fx_block_kernel<TG, F, false>;
      REPRO_NOTE_LAUNCH(kern, 0);
      kern<<<grid, BWD_THREADS_DIRECT, 0, stream>>>(
          gt, coords, part, grad_fx, flags, N, L, l, res[l], T_size, 0, ppb, vmax);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One level's launch on its plan: 'd' a plain launch of 512-thread blocks;
// 's' 1,024-thread blocks asking for the slab's bytes; 'c' the same blocks
// in clusters of pl.cluster (cudaLaunchKernelEx with a cluster dimension:
// the grid is padded to a multiple of it with blocks that carry no point).
// A launch the card refuses returns its error: nothing falls back.
template <typename TG, int F>
cudaError_t launch_fx_level(const TG* g, const float* coords, const int* part,
                            unsigned long long* grad_fx, unsigned long long* flags,
                            long long B, long long N, int L, int l, int res,
                            long long T_size, const repro::FxLevel& pl, float vmax,
                            cudaStream_t stream) {
  const long long unit = (long long)pl.points * pl.cluster;   // a cluster's points
  const dim3 grid((unsigned)((N + unit - 1) / unit * pl.cluster), (unsigned)B);
  const int rows = (int)pl.rows;
  if (pl.site == 'd') {
    const auto kern = hash_encode_bwd_fx_kernel<TG, F, 'd'>;
    REPRO_NOTE_LAUNCH(kern, 0);
    kern<<<grid, pl.threads, 0, stream>>>(g, coords, part, grad_fx, flags, N, L, l, res,
                                         T_size, rows, 0, pl.points, vmax);
    return cudaGetLastError();
  }
  if (pl.site == 's') {
    const auto kern = hash_encode_bwd_fx_kernel<TG, F, 's'>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
    REPRO_NOTE_LAUNCH(kern, pl.smem);
    kern<<<grid, pl.threads, pl.smem, stream>>>(g, coords, part, grad_fx, flags, N, L, l,
                                               res, T_size, rows, pl.span, pl.points,
                                               vmax);
    return cudaGetLastError();
  }
  if (pl.site != 'c') return cudaErrorInvalidValue;
  const auto kern = hash_encode_bwd_fx_kernel<TG, F, 'c'>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)pl.threads);
  cfg.dynamicSmemBytes = (size_t)pl.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  REPRO_NOTE_LAUNCH(kern, pl.smem);
  err = cudaLaunchKernelEx(&cfg, kern, g, coords, part, grad_fx, flags, N, L, l, res,
                           T_size, rows, pl.span, pl.points, vmax);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TG, int F>
cudaError_t launch_fx(const void* g, const float* coords, const int* part,
                      const int* res, const int* force, unsigned long long* grad_fx,
                      unsigned long long* flags, long long B, long long N, int L,
                      long long T_size, float vmax, cudaStream_t stream) {
  for (int l = 0; l < L; ++l) {
    const repro::FxLevel pl =
        repro::fx_level_plan(res[l], T_size, F, force ? force[l] : 0);
    if (pl.site == 0) return cudaErrorInvalidValue;
    const cudaError_t err = launch_fx_level<TG, F>(
        static_cast<const TG*>(g), coords, part, grad_fx, flags, B, N, L, l, res[l],
        T_size, pl, vmax, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
    REPRO_NOTE_LAUNCH(kern, smem);
    kern<<<grid, BWD_THREADS_STAGED, smem, stream>>>(g, coords, part, grad, N, L, level,
                                              res, T_size, (int)rows, ppb);
  } else {
    const auto kern = hash_encode_bwd_kernel<TG, F, false>;
    REPRO_NOTE_LAUNCH(kern, 0);
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

namespace repro {

FxLevel fx_level_plan(int res, long long T, int F, int force) {
  FxLevel pl = {};
  pl.rows = level_rows(res, T);
  const long long row_bytes = (long long)F * 8;
  int site = force & 0xff, cluster = force >> 8;
  if (site == 0) {   // the rule
    site = 'd';
    cluster = 1;
    if (pl.rows * row_bytes <= FX_STAGE_BUDGET) {
      site = 's';
    } else {
      for (int c = 2; c <= 8; c *= 2) {
        if ((pl.rows + c - 1) / c * row_bytes <= FX_STAGE_BUDGET) {
          site = 'c';
          cluster = c;
          break;
        }
      }
    }
  }
  if (site == 's' || site == 'd') cluster = 1;
  if ((site != 's' && site != 'c' && site != 'd') ||
      (site == 'c' && cluster != 2 && cluster != 4 && cluster != 8))
    return FxLevel{};   // site 0: not a plan
  pl.site = (char)site;
  pl.cluster = cluster;
  if (site == 'd') {
    pl.span = 0;
    pl.points = pl.threads = BWD_THREADS_DIRECT;
    pl.smem = 0;
    return pl;
  }
  pl.span = (int)((pl.rows + cluster - 1) / cluster);
  pl.points = bwd_points_per_block(pl.span, true);
  pl.threads = BWD_THREADS_STAGED;
  pl.smem = (int)(pl.span * row_bytes);
  return pl;
}

cudaError_t fx_scatter(const void* g, int g_bf16, const float* coords, const int* part,
                       const int* res, const int* force,
                       unsigned long long* grad_fx, unsigned long long* flags,
                       long long B, long long N, int L, long long T, int F, float vmax,
                       cudaStream_t s) {
  if (g_bf16) {
    switch (F) {
      case 1: return launch_fx<__nv_bfloat16, 1>(g, coords, part, res, force, grad_fx, flags, B, N, L, T, vmax, s);
      case 2: return launch_fx<__nv_bfloat16, 2>(g, coords, part, res, force, grad_fx, flags, B, N, L, T, vmax, s);
      case 4: return launch_fx<__nv_bfloat16, 4>(g, coords, part, res, force, grad_fx, flags, B, N, L, T, vmax, s);
      case 8: return launch_fx<__nv_bfloat16, 8>(g, coords, part, res, force, grad_fx, flags, B, N, L, T, vmax, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (F) {
    case 1: return launch_fx<float, 1>(g, coords, part, res, force, grad_fx, flags, B, N, L, T, vmax, s);
    case 2: return launch_fx<float, 2>(g, coords, part, res, force, grad_fx, flags, B, N, L, T, vmax, s);
    case 4: return launch_fx<float, 4>(g, coords, part, res, force, grad_fx, flags, B, N, L, T, vmax, s);
    case 8: return launch_fx<float, 8>(g, coords, part, res, force, grad_fx, flags, B, N, L, T, vmax, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

namespace {

// the conversion launch of the route: every entry of grad_fx to grad_tables
cudaError_t launch_fx_to_float(const unsigned long long* fx, const unsigned long long* fl,
                               void* grad_tables, long long P, int L, long long T_size,
                               int F, cudaStream_t s) {
  const long long per_part = (long long)L * T_size * F, total = P * per_part;
  const long long blocks = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
  REPRO_NOTE_LAUNCH(fx_to_float_kernel, 0);
  fx_to_float_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      fx, fl, static_cast<float*>(grad_tables), per_part, total);
  return cudaGetLastError();
}

}  // namespace

// The deterministic route of repro_hash_encode_bwd: the same g, coords,
// resolutions (host memory), part and shapes; force null (each level's plan
// by fx_level_plan's rule) or L int32 in host memory (a letter a level:
// fx_scatter.cuh); grad_fx (P,L,T,F) and flags (P,) int64, zeroed by the
// caller, take the fixed-point sums and the partitions' flag bits
// (FX_NONFINITE, FX_OVER); grad_tables (P,L,T,F) f32, unless null, gets every
// entry converted (NaN for a flagged partition). vmax = FX_BOUND / M, M the
// points of one partition (N times its rows in part): an entry takes at most
// 8 M contributions, so |sum| <= 2^62 + 4 M, and a contribution above vmax
// flags its partition. One launch per level, then the conversion.
extern "C" int repro_hash_encode_bwd_fx(const void* grad_out, const void* coords,
                                        const void* resolutions, const void* force,
                                        const void* part, void* grad_fx, void* flags,
                                        void* grad_tables,
                                        long long B, long long N, int L, long long P,
                                        long long T_size, int F, float vmax,
                                        int is_bf16, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535 || (is_bf16 && (reinterpret_cast<uintptr_t>(grad_out) & 15)))
    return (int)cudaErrorInvalidValue;
  unsigned long long* fx = static_cast<unsigned long long*>(grad_fx);
  unsigned long long* fl = static_cast<unsigned long long*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = repro::fx_scatter(
      grad_out, is_bf16, static_cast<const float*>(coords), static_cast<const int*>(part),
      static_cast<const int*>(resolutions), static_cast<const int*>(force), fx, fl, B, N,
      L, T_size, F, vmax, s);
  if (err != cudaSuccess || grad_tables == nullptr) return (int)err;
  return (int)launch_fx_to_float(fx, fl, grad_tables, P, L, T_size, F, s);
}

// The yardstick of repro_hash_encode_bwd_fx: the same operands (F = 4, no
// force), hash_encode_bwd_fx_block_kernel's launches (the level's slab in
// one block where it fits FX_STAGE_BUDGET, else direct), then the
// conversion unless grad_tables is null. For holding the scatter layer to
// its bits and its time.
extern "C" int repro_hash_encode_bwd_fx_block(const void* grad_out, const void* coords,
                                              const void* resolutions, const void* part,
                                              void* grad_fx, void* flags,
                                              void* grad_tables, long long B,
                                              long long N, int L, long long P,
                                              long long T_size, int F, float vmax,
                                              int is_bf16, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (F != 4 || B > 65535 || (is_bf16 && (reinterpret_cast<uintptr_t>(grad_out) & 15)))
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  const int* r = static_cast<const int*>(resolutions);
  const int* p = static_cast<const int*>(part);
  unsigned long long* fx = static_cast<unsigned long long*>(grad_fx);
  unsigned long long* fl = static_cast<unsigned long long*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16
      ? launch_bwd_fx_block<__nv_bfloat16>(grad_out, c, r, p, fx, fl, B, N, L, T_size, vmax, s)
      : launch_bwd_fx_block<float>(grad_out, c, r, p, fx, fl, B, N, L, T_size, vmax, s);
  if (err != cudaSuccess || grad_tables == nullptr) return (int)err;
  return (int)launch_fx_to_float(fx, fl, grad_tables, P, L, T_size, F, s);
}

// Each level's plan as repro_hash_encode_bwd_fx makes it (resolutions and
// force as it takes them, force may be null; out (L, 7) int64 in host
// memory): site (the letter's code, 0 for no plan), cluster, rows, span,
// points a block, threads a block, slab bytes.
extern "C" int repro_hash_encode_bwd_fx_plan(const void* resolutions, const void* force,
                                             int L, long long T_size, int F, void* out) {
  const int* r = static_cast<const int*>(resolutions);
  const int* fo = static_cast<const int*>(force);
  long long* o = static_cast<long long*>(out);
  for (int l = 0; l < L; ++l) {
    const repro::FxLevel pl = repro::fx_level_plan(r[l], T_size, F, fo ? fo[l] : 0);
    const long long row[7] = {pl.site, pl.cluster, pl.rows, pl.span, pl.points,
                              pl.threads, pl.smem};
    for (int k = 0; k < 7; ++k) o[7 * l + k] = row[k];
  }
  return 0;
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

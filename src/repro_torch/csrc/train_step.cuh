// The fused DVNR train step, minus the optimizer: for every partition and
// every sample of its batch, [draw the sample and gather its target,] encode,
// run the MLP forward, take the masked L1 cotangent, run the MLP backward
// and scatter the feature cotangent into the hash tables' gradient.
//
// Replaces: src/repro/kernels/fused_train_step/kernel.py,
//   fused_train_step_pallas (line 305; host-sampled batch),
//   fused_train_step_sampling_pallas (line 364; in-kernel sampling, volume
//     pinned in VMEM) and
//   fused_train_step_sampling_tiled_pallas (line 437; the same, volume
//     streamed through VMEM brick by brick),
// all up to their AdamW epilogue, which is adamw.cu's kernel here.
// One kernel body serves all three: the SAMPLING template flag picks drawing
// the batch in the kernel or reading it. The TPU's brick layout exists only
// to fit a 256^3 partition (69 MB) into 16 MiB of VMEM; on the H100 the
// volume stays in device memory and each sample's 8 corners are read through
// L1/L2, so the pinned and tiled variants are one kernel (sampling_brick
// changes nothing here).
//
// The kernel is a template of the parameter type TP, instantiated in two
// translation units so that their instantiations (W x F x variant, 24 each)
// compile in parallel: train_step.cu holds the float32 policy's
// (train_step_kernel<float>) and the C entries, train_step_bf16.cu the bf16
// policy's (train_step_kernel<__nv_bfloat16>: bfloat16 params, bfloat16
// compute).
//
// Design. The TPU kernel walks a (partition, batch tile) grid in order,
// accumulates gradients in VMEM scratch with `+=` and applies AdamW on the
// last tile. A GPU runs blocks in no order, so: grid (blocks, P); a block of
// TILE threads owns one partition's weights in shared memory (as float32,
// whatever TP) and walks the batch tiles of that partition with a stride, one
// sample per thread:
//   1. (SAMPLING) the counter-based draw of core/sampling.py on native
//      uint32 (20-round Threefry-2x32 of (row, word), top 24 bits to
//      [0,1), rows past n_uniform the Eq. 2 boundary mixture through logf,
//      cosf and sqrtf) and the trilinear gather from the ghost-padded
//      volume (lo clamped to n-2, the weight to [0,1], the 8 corners summed
//      with dz fastest), with explicitly rounded products and sums so the
//      build's FMA contraction cannot change the draws: uniform rows are
//      bit-exact against the plain version. The sampling stage is float32
//      under every policy, as in the JAX kernel;
//   2. the L-level hash encode into the row's shared x: hash_grid.cuh's
//      corner gather, one vector load per corner row;
//   3. the MLP forward, 4. the cotangent sign(pred - target) / (N D_out)
//      of rows < N (rows past the batch carry 0: the ragged edge is masked
//      here, as kernel.py:191-196 masks its padding), and the per-thread
//      |diff| sum for the loss, 5. the MLP backward (mlp_tile.cuh), with
//      the tile's dW summed over its rows in shared memory;
//   6. the 8-corner table scatter of the feature cotangent, hash_grid.cuh's
//      scatter_corners: lanes of a warp that hit one row are summed first,
//      and each group's leader adds the row once, straight into the float32
//      device gradient as one 16-byte atomic.
// After its last tile a block adds its dW (one atomicAdd per weight) and its
// loss sum (one atomicAdd) to device memory. AdamW waits for the kernel's
// end: the grid-wide dependency is the launch boundary. With g_feat given,
// the kernel stores the feature cotangent there instead of scattering it
// (the two-launch split with the level-major hash_encode_bwd, a yardstick).
//
// The deterministic route (the DET template flag, taken when PyTorch's
// torch.are_deterministic_algorithms_enabled() is true; its instantiations
// live in train_step_det.cu and train_step_det_bf16.cu) makes every sum
// independent of the order in which blocks and warps finish, and of the
// grid's size, so that a partition trains to the same bits alone on a rank
// as in a stacked P-partition launch:
//   - the batch tiles are cut into fixed groups of STEP_DET_TILES
//     consecutive tiles, and a block walks whole groups. A group's dW (its
//     tiles' in order, through the same shared-memory sums) and its loss
//     (each thread's rows, a fixed shuffle tree, then the warps in order)
//     are written to the group's row of a (P, groups, n_w + 1) buffer in
//     place of the atomics; adamw.cu sums the rows in group order;
//   - the table gradient is summed as int64 fixed point (hash_grid.cuh: its
//     scale, bound and overflow flag), converted to float32 by adamw.cu. The
//     step is split in two launches: the kernel writes each valid row's
//     feature cotangent to g_feat ((P,N,L*F) f32 scratch, 42 MB a
//     PRODUCTION256 step) and, in the sampling variant, its drawn
//     coordinates to g_coords ((P,N,3), 6.3 MB), and hash_encode.cu's
//     fixed-point scatter (fx_scatter) sums them, each level on its plan:
//     the slab in one block's shared memory, across a cluster's, or direct.
//     Both launches put rows 32k .. 32k+31 in one warp, so every
//     contribution is formed and rounded as it was inside the step, and the
//     int64 sums are its bits. The yardstick, train_step_det_fused_kernel,
//     keeps the adds inside the step with every level direct: F 8-byte
//     atomics a corner row to device memory, 79.5M a PRODUCTION256 step,
//     whose hot dense rows cost most (its stage clock, step::DetStageClock,
//     splits the cycles into the dense levels' scatter, the hashed levels'
//     and the rest; PERF.md). Staging levels inside this kernel instead
//     could hold only level 0's slab beside the MLP tile without losing
//     blocks an SM, and would leave the rest direct.
//
// The bf16 policy (TP = bfloat16) rounds where the plain version
// (fused_train_step/ref.py, train_step_grads_ref) rounds, and sums in
// float32 everywhere else:
//   - encode: bfloat16 table rows, each corner weight rounded to bfloat16,
//     the 8 corners summed in float32, the feature rounded once (JAX's
//     Pallas kernel sums the corners in bfloat16, kernel.py:98);
//   - MLP forward: float32 sums, each layer's output rounded to bfloat16;
//   - loss: the prediction rounded to bfloat16, the difference taken in
//     float32 against the float32 target, the cotangent sign / (N D_out)
//     rounded to bfloat16 (kernel.py:186-190);
//   - MLP backward: each layer's delta rounded to bfloat16 before its ReLU
//     mask, dW summed in float32;
//   - table scatter: the feature cotangent rounded to bfloat16, scattered
//     with float32 corner weights into the float32 gradient
//     (kernel.py:207-213).
// The gradients stay float32 for adamw.cu's master-weight update.
//
// Bound: per PRODUCTION256 step (8 partitions x 65,536 samples, L=5, F=4)
// the float work is about 2.3 GFLOP (35 us at the f32 peak) and the bytes
// about 27 MB (8 us; bf16 tables and weights halve the state's share). What
// sets the pace on an H100 is the instructions of the per-sample passes
// (draws, encode, MLP forward and backward, the dW pass) and the encode's L2
// gathers, about 0.34 ms a step, and the scatter's 21M corner adds, about
// 0.2 ms more. The pre-reduction takes the coarse dense levels' adds (125 to
// 4,913 rows) off a few hot addresses, and the direct adds are
// fire-and-forget, so the other warps' MLP work hides them. On the default
// route float32 gradient slabs staged in shared memory for the coarse
// levels, as the standalone backward stages them, measured slower here
// (a shared float add is a compare-and-swap loop that stalls the warp, and a
// slab costs blocks per SM; PERF.md), so every level goes straight to device
// memory as one 16-byte atomic a row. The deterministic route's int64 adds
// are F requests a row and cannot be fused so; they leave the kernel (the
// split above).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "hash_grid.cuh"
#include "mlp_tile.cuh"

namespace repro {

constexpr int STEP_C_MAX = 4;
constexpr int STEP_MAX_LEVELS = 32;
// batch tiles per group of the deterministic route: 128 groups of 4 tiles of
// 128 rows at N = 65,536, enough groups to fill the card with one partition
constexpr int STEP_DET_TILES = 4;

struct StepArgs {
  const float* coords;        // (P,N,3)        plain mode
  const float* target;        // (P,N,D_out)    plain mode
  const float* vol;           // (P,nx,ny,nz,C) sampling mode
  const long long* seeds;     // (P,2) uint32 words in int64, sampling mode
  const void *tab, *win, *whid, *wout;   // the parameter type TP
  float *g_tab, *g_win, *g_whid, *g_wout, *loss_sum;
  float* g_feat;              // (P,N,L*F) or null: see the header
  // the deterministic route's outputs (null otherwise): the int64 fixed-point
  // table gradient (P,L,T,F), the per-group dW and loss (P,groups,n_w+1)
  // and the per-partition flags (P,); fx_vmax = FX_BOUND / N
  unsigned long long* g_tab_fx;
  float* partials;
  unsigned long long* flags;
  float fx_vmax;
  // the deterministic route's split (see the header): the sampling variant's
  // drawn coordinates (P,N,3), or null; the clocked yardstick's stage
  // counts (DetStageClock), or null
  float* g_coords;
  unsigned long long* clocks;
  long long N, T, nx, ny, nz, n_uniform;
  int L, D_in, n_hidden, n_hid_slab, D_out, ghost;
  float sigma;
  int res[STEP_MAX_LEVELS];
};

// The launch's shape: threads per block (the MLP tile's rows), the shared
// memory (the MLP tile and one float per row for the loss reduction) and
// the blocks per partition.
struct StepShape {
  int tile;
  size_t smem;
  long long blocks;
  long long groups;   // the deterministic route's tile groups (0 otherwise)
};

// Each (parameter type, route, variant) has a translation unit of its own,
// so that nvcc compiles its 12 kernels (W x F) beside the others': the
// float32 host-sampled variant in train_step.cu, with the C entry; the rest
// in train_step{,_bf16,_det,_det_bf16}[_sampling].cu.
using StepLaunch = cudaError_t(const StepArgs& a, const StepShape& sh, long long P,
                               int W, int F, cudaStream_t stream);
StepLaunch train_step_launch_sampling, train_step_launch_bf16,
    train_step_launch_bf16_sampling, train_step_launch_det,
    train_step_launch_det_sampling, train_step_launch_det_bf16,
    train_step_launch_det_bf16_sampling;
// the deterministic route's fused design, the yardstick (W = 16, F = 4 only;
// train_step_det_fused.cu): is_bf16, sampling, clocked pick the instantiation
cudaError_t train_step_launch_det_fused(const StepArgs& a, const StepShape& sh,
                                        long long P, int W, int F, int is_bf16,
                                        int sampling, int clocked, cudaStream_t stream);

namespace step {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// the 20-round Threefry-2x32 of core/sampling.py (jax.random's cipher)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// counter_coords of one global sample row
__device__ __forceinline__ void sample_coords(uint32_t k0, uint32_t k1,
                                              long long row, long long n_uniform,
                                              float sigma, float c[3]) {
  uint32_t a[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) threefry2x32(k0, k1, (uint32_t)row, (uint32_t)j, a[j], b[j]);
#pragma unroll
  for (int d = 0; d < 3; ++d) c[d] = uniform01(a[d]);
  if (row >= n_uniform) {
    const int axis = min((int)__fmul_rn(uniform01(a[3]), 3.0f), 2);
    const float side = (float)min((int)__fmul_rn(uniform01(b[0]), 2.0f), 1);
    const float u_r = uniform01(b[1]), u_t = uniform01(b[2]);
    const float mag =
        __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(__fsub_rn(1.0f, u_r)))), sigma);
    const float off = fminf(
        fmaxf(fabsf(__fmul_rn(mag, cosf(__fmul_rn(6.2831853071795864769f, u_t)))),
              0.0f),
        1.0f);
    c[axis] = __fadd_rn(__fmul_rn(side, __fsub_rn(1.0f, off)),
                        __fmul_rn(__fsub_rn(1.0f, side), off));
  }
}

// sample_trilinear of one coordinate: C channels of the ghost-padded volume
__device__ __forceinline__ void gather_trilinear(const float* __restrict__ vol,
                                                 long long nx, long long ny,
                                                 long long nz, int C, int ghost,
                                                 const float c[3], float* out) {
  const long long n[3] = {nx, ny, nz};
  long long lo[3];
  float w[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(
        __fadd_rn(__fmul_rn(c[d], (float)(n[d] - 2 * ghost)), -0.5f), (float)ghost);
    const float lof = fminf(fmaxf(floorf(pos), 0.0f), (float)(n[d] - 2));
    lo[d] = (long long)lof;
    w[d] = fminf(fmaxf(__fsub_rn(pos, lof), 0.0f), 1.0f);
  }
#pragma unroll
  for (int ch = 0; ch < STEP_C_MAX; ++ch) out[ch] = 0.0f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const float ww = __fmul_rn(
            __fmul_rn(dx ? w[0] : __fsub_rn(1.0f, w[0]), dy ? w[1] : __fsub_rn(1.0f, w[1])),
            dz ? w[2] : __fsub_rn(1.0f, w[2]));
        const float* v = vol + (((lo[0] + dx) * ny + (lo[1] + dy)) * nz + (lo[2] + dz)) * C;
#pragma unroll
        for (int ch = 0; ch < STEP_C_MAX; ++ch)
          if (ch < C) out[ch] = __fadd_rn(out[ch], __fmul_rn(ww, __ldg(v + ch)));
      }
}

// The block's sum of v, the same in thread 0 whatever the timing: a shuffle
// tree in each warp, then the warps' sums in order (red: one float a warp).
// Every thread calls it; it syncs once.
__device__ __forceinline__ float block_sum(float v, float* red, int r, int tile) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((r & 31) == 0) red[r >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (r == 0)
    for (int w = 0; w < (tile + 31) / 32; ++w) s += red[w];
  return s;
}

// The stage clock of the deterministic route's fused scatter (the
// yardstick's clocked instantiation, a measurement): each warp counts the
// cycles (clock64) of its table scatter at the dense levels, at the hashed
// levels, and of the rest of the step, and adds them, then its lifetime in
// ns (the global timer), to a global array of kDetStages + 1.
enum DetStage { kDetRest, kDetDense, kDetHashed, kDetStages };

struct StepNoClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct DetStageClock {
  long long last;
  unsigned long long born;
  unsigned long long t[kDetStages];
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < kDetStages; ++i) t[i] = 0;
    born = global_ns();
    last = clock64();
  }
  __device__ __forceinline__ void mark(int s) {
    const long long now = clock64();
    t[s] += (unsigned long long)(now - last);
    last = now;
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < kDetStages; ++i) atomicAdd(out + i, t[i]);
      atomicAdd(out + kDetStages, global_ns() - born);
    }
  }
};

}  // namespace step

// The step's body for parameters of type TP (float: the float32 policy;
// __nv_bfloat16: the bf16 policy, RB below, with the rounding points of the
// header). DET without FUSED_FX is the deterministic route's split:
// the feature cotangent to g_feat (and the drawn coordinates to g_coords),
// no scatter here. DET with FUSED_FX is the route's fused design before the
// split (the yardstick): the fixed-point adds in the step, every level
// straight to device memory. Clk marks the scatter's stages (the yardstick's
// clocked instantiation; step::StepNoClock elsewhere).
template <typename TP, int W, int F, bool SAMPLING, bool DET, bool FUSED_FX, typename Clk>
__device__ __forceinline__ void train_step_body(const StepArgs& a, Clk& clk) {
  constexpr bool RB = sizeof(TP) == 2;
  constexpr bool SPLIT = DET && !FUSED_FX;
  extern __shared__ __align__(16) float smem[];
  const int p = blockIdx.y;
  const int tile = blockDim.x, r = threadIdx.x;
  const repro::MlpTile t =
      repro::mlp_tile_carve(smem, a.D_in, W, a.n_hidden, a.D_out, tile);
  float* red = smem + repro::mlp_tile_floats(a.D_in, W, a.n_hidden, a.D_out, tile);
  const int L = a.L;
  const long long T = a.T;
  const bool scatter = !SPLIT && a.g_feat == nullptr;
  const long long hid_off = (long long)p * a.n_hid_slab * W * W;
  repro::mlp_tile_load<TP>(t, static_cast<const TP*>(a.win) + (long long)p * t.n_in,
                           static_cast<const TP*>(a.whid) + hid_off,
                           static_cast<const TP*>(a.wout) + (long long)p * t.n_out);
  // (mlp_tile_load ends with a sync)

  const TP* tab = static_cast<const TP*>(a.tab) + (long long)p * L * T * F;
  float* gtab = DET ? nullptr : a.g_tab + (long long)p * L * T * F;
  const float nd = (float)(a.N * a.D_out);
  uint32_t k0 = 0, k1 = 0;
  const float* vol = nullptr;
  if (SAMPLING) {
    k0 = (uint32_t)a.seeds[2 * p];
    k1 = (uint32_t)a.seeds[2 * p + 1];
    vol = a.vol + (long long)p * a.nx * a.ny * a.nz * a.D_out;
  }
  float loss_part = 0.0f;
  unsigned bad = 0;   // the deterministic route's flag bits (hash_grid.cuh)
  const long long n_tiles = (a.N + tile - 1) / tile;
  // DET: a block walks whole groups of STEP_DET_TILES tiles; otherwise single
  // tiles. Whole blocks stride, so that every lane of a warp reaches the
  // warp-wide pre-reduction of the scatter; rows past N carry no sample
  const long long n_items = DET ? (n_tiles + STEP_DET_TILES - 1) / STEP_DET_TILES
                                : n_tiles;
  for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
    const long long t_end = DET ? min((it + 1) * STEP_DET_TILES, n_tiles) : it + 1;
    for (long long ti = DET ? it * STEP_DET_TILES : it; ti < t_end; ++ti) {
      const long long row = ti * tile + r;
      const bool valid = row < a.N;
      float c[3] = {0.0f, 0.0f, 0.0f};
      float tgt[STEP_C_MAX] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (SAMPLING) {
        step::sample_coords(k0, k1, row, a.n_uniform, a.sigma, c);
        step::gather_trilinear(vol, a.nx, a.ny, a.nz, a.D_out, a.ghost, c, tgt);
        if (SPLIT && valid && a.g_coords != nullptr) {
          float* o = a.g_coords + ((long long)p * a.N + row) * 3;
  #pragma unroll
          for (int d = 0; d < 3; ++d) o[d] = c[d];
        }
      } else if (valid) {
        const long long prow = (long long)p * a.N + row;
  #pragma unroll
        for (int d = 0; d < 3; ++d) c[d] = a.coords[prow * 3 + d];
        for (int d = 0; d < a.D_out; ++d) tgt[d] = a.target[prow * a.D_out + d];
      }
      // encode: every level's F features into this row of x
      float* xr = t.x + r * t.sx;
      for (int l = 0; l < L; ++l) {
        const repro::LevelGeom geo = repro::level_geom(c, a.res[l], T);
        float acc[F];
        repro::gather_corners<TP, F>(geo, tab + (long long)l * T * F, acc);
  #pragma unroll
        for (int f = 0; f < F; ++f) xr[l * F + f] = repro::round_if<RB>(acc[f]);
      }
      repro::mlp_tile_forward<W, RB>(t, r);
      // masked L1: loss sum and cotangent sign(diff) / (N * D_out)
      for (int d = 0; d < a.D_out; ++d) {
        const float diff = repro::mlp_tile_out<W, RB>(t, r, d) - tgt[d];
        float g = 0.0f;
        if (valid) {
          loss_part += fabsf(diff);
          const float s = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : diff);
          g = repro::round_if<RB>(s / nd);
        }
        t.g[r * t.sg + d] = g;
      }
      float d0[W];
      repro::mlp_tile_backward<W, RB>(t, r, d0);
      // hash-encode backward: the feature cotangent into the tables' gradient
      for (int l = 0; l < L; ++l) {
        float df[F];
  #pragma unroll
        for (int f = 0; f < F; ++f)
          df[f] = repro::round_if<RB>(repro::mlp_tile_dx<W>(t, d0, l * F + f));
        if (!scatter) {
          if (valid) {
            float* o = a.g_feat + ((long long)p * a.N + row) * a.D_in + l * F;
  #pragma unroll
            for (int f = 0; f < F; ++f) o[f] = df[f];
          }
          continue;
        }
        const repro::LevelGeom geo = repro::level_geom(c, a.res[l], T);
        if constexpr (DET) {
          clk.mark(step::kDetRest);
          repro::scatter_corners_fx<F>(
              geo, df, valid, repro::FxAtomic{a.g_tab_fx + ((long long)p * L + l) * T * F},
              a.fx_vmax, bad);
          clk.mark(geo.dense ? step::kDetDense : step::kDetHashed);
        } else {
          repro::scatter_corners<F, false>(geo, df, valid, gtab + (long long)l * T * F);
        }
      }
      __syncthreads();
      repro::mlp_tile_accumulate<W>(t, tile);
      __syncthreads();
    }
    if constexpr (DET) {
      // the group's row: its dW (dw is complete after the tile loop's last
      // sync), then dw zeroed for the next group, and its loss
      float* out = a.partials + ((long long)p * n_items + it) * (t.n_w + 1);
      for (int i = r; i < t.n_w; i += tile) {
        out[i] = t.dw[i];
        t.dw[i] = 0.0f;
      }
      const float s = step::block_sum(loss_part, red, r, tile);
      if (r == 0) out[t.n_w] = s;
      loss_part = 0.0f;
      __syncthreads();
    }
  }
  if constexpr (DET) {
    if (bad) atomicOr(a.flags + p, (unsigned long long)bad);   // faults only
    clk.mark(step::kDetRest);
    return;
  }
  // the block's loss sum and its dW: one atomicAdd each
  const float s = step::block_sum(loss_part, red, r, tile);
  if (r == 0) atomicAdd(a.loss_sum + p, s);
  repro::mlp_tile_flush(t, a.g_win + (long long)p * t.n_in, a.g_whid + hid_off,
                        a.g_wout + (long long)p * t.n_out);
}

template <typename TP, int W, int F, bool SAMPLING, bool DET>
__global__ void train_step_kernel(const StepArgs a) {
  step::StepNoClock clk;
  train_step_body<TP, W, F, SAMPLING, DET, false>(a, clk);
}

// The deterministic route's fused design (the yardstick of the split, at W =
// 16, F = 4; launched only through repro_train_step's det = 3 and 4, the
// latter with Clk = step::DetStageClock into a.clocks)
template <typename TP, bool SAMPLING, typename Clk>
__global__ void train_step_det_fused_kernel(const StepArgs a) {
  Clk clk;
  clk.start();
  train_step_body<TP, 16, 4, SAMPLING, true, true>(a, clk);
  clk.flush(a.clocks);
}

// False if no tile fits. The shape does not depend on the parameter type:
// shared memory holds float32 weights under every policy.
// The deterministic route's grid is capped at its groups; its bits do not
// depend on the grid.
inline bool step_shape(int L, int F, int W, int n_hidden, int D_out, long long N,
                       long long P, bool det, StepShape* s) {
  // one extra float per row holds the loss reduction's per-warp sums
  s->tile = repro::mlp_pick_tile(L * F, W, n_hidden, D_out, 1, &s->smem);
  if (s->tile == 0) return false;
  const long long n_tiles = (N + s->tile - 1) / s->tile;
  s->groups = det ? (n_tiles + STEP_DET_TILES - 1) / STEP_DET_TILES : 0;
  s->blocks = repro::blocks_per_row(det ? s->groups : n_tiles, P, s->tile, s->smem);
  return true;
}

template <typename TP, bool DET, bool SAMPLING, int W, int F>
cudaError_t step_launch_wf(const StepArgs& a, const StepShape& sh, long long P,
                           cudaStream_t stream) {
  const auto kernel = &train_step_kernel<TP, W, F, SAMPLING, DET>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (e != cudaSuccess) return e;
  REPRO_NOTE_LAUNCH(kernel, sh.smem);
  kernel<<<dim3((unsigned)sh.blocks, (unsigned)P), sh.tile, sh.smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TP, bool DET, bool SAMPLING, int W>
cudaError_t step_launch_w(const StepArgs& a, const StepShape& sh, long long P, int F,
                          cudaStream_t stream) {
  switch (F) {
    case 1: return step_launch_wf<TP, DET, SAMPLING, W, 1>(a, sh, P, stream);
    case 2: return step_launch_wf<TP, DET, SAMPLING, W, 2>(a, sh, P, stream);
    case 4: return step_launch_wf<TP, DET, SAMPLING, W, 4>(a, sh, P, stream);
    case 8: return step_launch_wf<TP, DET, SAMPLING, W, 8>(a, sh, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

// every (W, F) instantiation of the kernel for parameter type TP, route DET
// and variant SAMPLING
template <typename TP, bool DET, bool SAMPLING>
cudaError_t step_launch(const StepArgs& a, const StepShape& sh, long long P, int W,
                        int F, cudaStream_t stream) {
  switch (W) {
    case 16: return step_launch_w<TP, DET, SAMPLING, 16>(a, sh, P, F, stream);
    case 32: return step_launch_w<TP, DET, SAMPLING, 32>(a, sh, P, F, stream);
    case 64: return step_launch_w<TP, DET, SAMPLING, 64>(a, sh, P, F, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

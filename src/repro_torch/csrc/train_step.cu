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
// One source serves all three: the SAMPLING template flag picks drawing the
// batch in the kernel or reading it. The TPU's brick layout exists only to
// fit a 256^3 partition (69 MB) into 16 MiB of VMEM; on the H100 the volume
// stays in device memory and each sample's 8 corners are read through L1/L2,
// so the pinned and tiled variants are one kernel (sampling_brick changes
// nothing here).
//
// Design. The TPU kernel walks a (partition, batch tile) grid in order,
// accumulates gradients in VMEM scratch with `+=` and applies AdamW on the
// last tile. A GPU runs blocks in no order, so: grid (blocks, P); a block of
// TILE threads owns one partition's weights in shared memory and walks the
// batch tiles of that partition with a stride, one sample per thread:
//   1. (SAMPLING) the counter-based draw of core/sampling.py on native
//      uint32 (20-round Threefry-2x32 of (row, word), top 24 bits to
//      [0,1), rows past n_uniform the Eq. 2 boundary mixture through logf,
//      cosf and sqrtf) and the trilinear gather from the ghost-padded
//      volume (lo clamped to n-2, the weight to [0,1], the 8 corners summed
//      with dz fastest), with explicitly rounded products and sums so the
//      build's FMA contraction cannot change the draws: uniform rows are
//      bit-exact against the plain version;
//   2. the L-level hash encode (hash_grid.cuh) into the row's shared x;
//   3. the MLP forward, 4. the cotangent sign(pred - target) / (N D_out)
//      of rows < N (rows past the batch carry 0: the ragged edge is masked
//      here, as kernel.py:191-196 masks its padding), and the per-thread
//      |diff| sum for the loss, 5. the MLP backward (mlp_tile.cuh), with
//      the tile's dW summed over its rows in shared memory;
//   6. the 8-corner table scatter of the feature cotangent: 8 L F atomic
//      adds per sample into the float32 gradient the wrapper zeroed.
// After its last tile a block adds its dW (one atomicAdd per weight) and its
// loss sum (one atomicAdd) to device memory. AdamW waits for the kernel's
// end: the grid-wide dependency is the launch boundary.
//
// Bound: the table scatter's atomics. Per PRODUCTION256 step (8 partitions
// x 65,536 samples, L=5, F=4) the scatter is 84M float32 atomic adds, the
// float work about 2.3 GFLOP (35 us at the f32 peak) and the bytes about
// 27 MB (the ~4M distinct voxels a batch's corners touch, the tables read
// and their gradients written: 8 us). Three of the five levels are dense
// with 125 to 4,913 rows, so their adds pile onto a few thousand addresses,
// and each lane sends its F features as F scattered atomic instructions.
// This first version leaves both in place and measures them (PERF.md).
#include <stdint.h>

#include "common.cuh"
#include "hash_grid.cuh"
#include "mlp_tile.cuh"

namespace {

constexpr int F_MAX = 8;
constexpr int C_MAX = 4;

struct StepArgs {
  const float* coords;        // (P,N,3)        plain mode
  const float* target;        // (P,N,D_out)    plain mode
  const float* vol;           // (P,nx,ny,nz,C) sampling mode
  const long long* seeds;     // (P,2) uint32 words in int64, sampling mode
  const float *tab, *win, *whid, *wout;
  float *g_tab, *g_win, *g_whid, *g_wout, *loss_sum;
  const int* res;
  long long N, T, nx, ny, nz, n_uniform;
  int L, F, D_in, n_hidden, n_hid_slab, D_out, ghost;
  float sigma;
};

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
  for (int ch = 0; ch < C_MAX; ++ch) out[ch] = 0.0f;
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
        for (int ch = 0; ch < C_MAX; ++ch)
          if (ch < C) out[ch] = __fadd_rn(out[ch], __fmul_rn(ww, __ldg(v + ch)));
      }
}

template <int W, bool SAMPLING>
__global__ void train_step_kernel(const StepArgs a) {
  extern __shared__ float smem[];
  const int p = blockIdx.y;
  const int tile = blockDim.x, r = threadIdx.x;
  const repro::MlpTile t =
      repro::mlp_tile_carve(smem, a.D_in, W, a.n_hidden, a.D_out, tile);
  float* red = smem + repro::mlp_tile_floats(a.D_in, W, a.n_hidden, a.D_out, tile);
  const long long hid_off = (long long)p * a.n_hid_slab * W * W;
  repro::mlp_tile_load(t, a.win + (long long)p * t.n_in, a.whid + hid_off,
                       a.wout + (long long)p * t.n_out);

  const int L = a.L, F = a.F;
  const long long T = a.T;
  const float* tab = a.tab + (long long)p * L * T * F;
  float* gtab = a.g_tab + (long long)p * L * T * F;
  const float nd = (float)(a.N * a.D_out);
  uint32_t k0 = 0, k1 = 0;
  const float* vol = nullptr;
  if (SAMPLING) {
    k0 = (uint32_t)a.seeds[2 * p];
    k1 = (uint32_t)a.seeds[2 * p + 1];
    vol = a.vol + (long long)p * a.nx * a.ny * a.nz * a.D_out;
  }
  float loss_part = 0.0f;
  const long long n_tiles = (a.N + tile - 1) / tile;
  for (long long ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const long long row = ti * tile + r;
    const bool valid = row < a.N;
    float c[3] = {0.0f, 0.0f, 0.0f};
    float tgt[C_MAX] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (SAMPLING) {
      sample_coords(k0, k1, row, a.n_uniform, a.sigma, c);
      gather_trilinear(vol, a.nx, a.ny, a.nz, a.D_out, a.ghost, c, tgt);
    } else if (valid) {
      const long long prow = (long long)p * a.N + row;
#pragma unroll
      for (int d = 0; d < 3; ++d) c[d] = a.coords[prow * 3 + d];
      for (int d = 0; d < a.D_out; ++d) tgt[d] = a.target[prow * a.D_out + d];
    }
    // encode: every level's F features into this row of x
    float* xr = t.x + r * t.sx;
    for (int l = 0; l < L; ++l) {
      const repro::LevelGeom geo = repro::level_geom(c, __ldg(a.res + l), T);
      const float* tl = tab + (long long)l * T * F;
      float acc[F_MAX];
#pragma unroll
      for (int f = 0; f < F_MAX; ++f) acc[f] = 0.0f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dz = 0; dz < 2; ++dz) {
            const float ww = repro::corner_weight(geo, dx, dy, dz);
            const float* tr = tl + (long long)repro::corner_index(geo, dx, dy, dz) * F;
#pragma unroll
            for (int f = 0; f < F_MAX; ++f)
              if (f < F) acc[f] += ww * tr[f];
          }
#pragma unroll
      for (int f = 0; f < F_MAX; ++f)
        if (f < F) xr[l * F + f] = acc[f];
    }
    repro::mlp_tile_forward<W>(t, r);
    // masked L1: loss sum and cotangent sign(diff) / (N * D_out)
    for (int d = 0; d < a.D_out; ++d) {
      const float diff = repro::mlp_tile_out<W>(t, r, d) - tgt[d];
      float g = 0.0f;
      if (valid) {
        loss_part += fabsf(diff);
        const float s = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : diff);
        g = s / nd;
      }
      t.g[r * t.sg + d] = g;
    }
    repro::mlp_tile_backward<W>(t, r);
    // hash-encode backward: the feature cotangent into the tables' gradient
    if (valid) {
      for (int l = 0; l < L; ++l) {
        float df[F_MAX];
#pragma unroll
        for (int f = 0; f < F_MAX; ++f)
          df[f] = f < F ? repro::mlp_tile_dx<W>(t, r, l * F + f) : 0.0f;
        const repro::LevelGeom geo = repro::level_geom(c, __ldg(a.res + l), T);
        float* gl = gtab + (long long)l * T * F;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dz = 0; dz < 2; ++dz) {
              const float ww = repro::corner_weight(geo, dx, dy, dz);
              float* gr = gl + (long long)repro::corner_index(geo, dx, dy, dz) * F;
#pragma unroll
              for (int f = 0; f < F_MAX; ++f)
                if (f < F) atomicAdd(gr + f, ww * df[f]);
            }
      }
    }
    __syncthreads();
    repro::mlp_tile_accumulate<W>(t, tile);
    __syncthreads();
  }
  // the block's loss sum: warp shuffles, then one add per warp in shared memory
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) loss_part += __shfl_xor_sync(0xffffffffu, loss_part, o);
  if ((r & 31) == 0) red[r >> 5] = loss_part;
  __syncthreads();
  if (r == 0) {
    float s = 0.0f;
    for (int w = 0; w < (tile + 31) / 32; ++w) s += red[w];
    atomicAdd(a.loss_sum + p, s);
  }
  repro::mlp_tile_flush(t, a.g_win + (long long)p * t.n_in, a.g_whid + hid_off,
                        a.g_wout + (long long)p * t.n_out);
}

template <int W>
cudaError_t launch_w(const StepArgs& a, long long P, bool sampling,
                     cudaStream_t stream) {
  size_t smem = 0;
  // one extra float per row holds the loss reduction's per-warp sums
  const int tile = repro::mlp_pick_tile(a.D_in, W, a.n_hidden, a.D_out, 1, &smem);
  if (tile == 0) return cudaErrorInvalidValue;
  void (*kernel)(const StepArgs) =
      sampling ? &train_step_kernel<W, true> : &train_step_kernel<W, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n_tiles = (a.N + tile - 1) / tile;
  const dim3 grid((unsigned)repro::blocks_per_row(n_tiles, P, tile, smem), (unsigned)P);
  kernel<<<grid, tile, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain mode (sampling = 0): coords (P,N,3), target (P,N,D_out).
// Sampling mode: volumes (P,nx,ny,nz,D_out) ghost-padded, seeds (P,2) uint32
// words held in int64, N = n_batch rows of which the first n_uniform are
// uniform. State: tab (P,L,T,F), win (P,L*F,W), whid (P,n_hid_slab,W,W),
// wout (P,W,D_out), all float32. Outputs, zeroed by the caller and added
// into: g_tab / g_win / g_whid / g_wout (the state's shapes) and loss_sum
// (P,) = sum over rows and outputs of |pred - target|.
extern "C" int repro_train_step(
    const void* coords, const void* target, const void* volumes,
    const void* seeds, const void* tab, const void* win, const void* whid,
    const void* wout, void* g_tab, void* g_win, void* g_whid, void* g_wout,
    void* loss_sum, const void* resolutions, long long P, long long N, int L,
    long long T, int F, int W, int n_hidden, int n_hid_slab, int D_out,
    long long nx, long long ny, long long nz, int ghost, long long n_uniform,
    float sigma, int sampling, void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (P > 65535 || n_hidden < 1 || F < 1 || F > F_MAX || D_out < 1 ||
      D_out > C_MAX)
    return (int)cudaErrorInvalidValue;
  if (sampling ? (volumes == nullptr || seeds == nullptr)
               : (coords == nullptr || target == nullptr))
    return (int)cudaErrorInvalidValue;
  StepArgs a;
  a.coords = static_cast<const float*>(coords);
  a.target = static_cast<const float*>(target);
  a.vol = static_cast<const float*>(volumes);
  a.seeds = static_cast<const long long*>(seeds);
  a.tab = static_cast<const float*>(tab);
  a.win = static_cast<const float*>(win);
  a.whid = static_cast<const float*>(whid);
  a.wout = static_cast<const float*>(wout);
  a.g_tab = static_cast<float*>(g_tab);
  a.g_win = static_cast<float*>(g_win);
  a.g_whid = static_cast<float*>(g_whid);
  a.g_wout = static_cast<float*>(g_wout);
  a.loss_sum = static_cast<float*>(loss_sum);
  a.res = static_cast<const int*>(resolutions);
  a.N = N; a.T = T; a.nx = nx; a.ny = ny; a.nz = nz; a.n_uniform = n_uniform;
  a.L = L; a.F = F; a.D_in = L * F; a.n_hidden = n_hidden;
  a.n_hid_slab = n_hid_slab; a.D_out = D_out; a.ghost = ghost; a.sigma = sigma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 16: return (int)launch_w<16>(a, P, sampling != 0, s);
    case 32: return (int)launch_w<32>(a, P, sampling != 0, s);
    case 64: return (int)launch_w<64>(a, P, sampling != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One block's tile of rows through the bias-free ReLU MLP, forward and
// backward, with the weight gradients reduced in shared memory, on the CUDA
// cores: the core of the fused train step (train_step.cuh; the MLP backward
// kernel runs on the tensor cores, mlp_mma.cuh). Shared memory and every sum
// are float32. Under the bf16
// compute policy (the RB template flag) the values the plain version stores
// in bfloat16 are rounded where it rounds them: each layer's ReLU output and
// the prediction in the forward, and in the backward each layer's delta
// before its ReLU mask (the plain version's autograd rounds a cotangent to
// bfloat16 where it crosses a bfloat16 activation). With RB false (the
// float32 policy) no rounding is compiled in.
//
// A block of TILE threads owns TILE rows, one row per thread. Shared memory
// holds, in this order (all float32):
//   w   [n_w]          the row partition's weights: w_in (D_in x W), the
//                      H-1 hidden layers (W x W each), w_out (W x D_out)
//   dw  [n_w]          the block's weight-gradient sums, same layout
//   x   [TILE][sx]     the layer-0 inputs
//   act [H][TILE][sw]  each layer's ReLU outputs
//   dl  [H][TILE][sw]  each layer's delta (cotangent after the ReLU mask)
//   g   [TILE][sg]     the output cotangent
// Per-row arrays are row-major with an odd row stride. In the per-row
// passes a warp's 32 threads touch one column of 32 rows, which an odd
// stride spreads over the 32 banks; in the weight-gradient pass a warp's
// threads share a row and touch consecutive columns. Neither pass has bank
// conflicts.
//
// The per-row passes read each weight row as float4 broadcasts (every lane
// of a warp reads the same weights; the weight blocks start 16-byte
// aligned: W is a multiple of 4, and so is every block's offset) and keep
// the deltas they consume in registers: the layer above's while a hidden
// layer's deltas are formed, the first layer's while the input cotangent
// is formed. The sums run in the same order as a plain loop over j.
//
// The weight gradient of a tile is a sum over its rows. The TPU kernels
// accumulate it with `+=` across an in-order grid; here each thread takes
// 2 x 4 blocks of a weight matrix and sums their products over the tile's
// rows in registers, then into dw (no atomics inside the block); the
// caller adds dw to the global gradient once per block, one atomicAdd per
// weight.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"

namespace repro {

// v rounded to bfloat16 and back under the bf16 compute policy, else v
template <bool RB>
__device__ __forceinline__ float round_if(float v) {
  if constexpr (RB) {
    return round_to<__nv_bfloat16>(v);
  } else {
    return v;
  }
}

__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

struct MlpTile {
  int D_in, H, D_out;          // W is the kernels' template parameter
  int n_in, n_hid, n_out, n_w; // weight counts per partition
  int sx, sw, sg;              // row strides
  float *w, *dw, *x, *act, *dl, *g;
};

// floats of shared memory one block needs
__host__ __device__ __forceinline__ long long mlp_tile_floats(int D_in, int W,
                                                              int H, int D_out,
                                                              int tile) {
  const long long n_w = (long long)D_in * W + (long long)(H - 1) * W * W +
                        (long long)W * D_out;
  return 2 * n_w + (long long)tile * (odd_stride(D_in) + 2LL * H * odd_stride(W) +
                                      odd_stride(D_out));
}

__device__ __forceinline__ MlpTile mlp_tile_carve(float* smem, int D_in, int W,
                                                  int H, int D_out, int tile) {
  MlpTile t;
  t.D_in = D_in; t.H = H; t.D_out = D_out;
  t.n_in = D_in * W; t.n_hid = (H - 1) * W * W; t.n_out = W * D_out;
  t.n_w = t.n_in + t.n_hid + t.n_out;
  t.sx = odd_stride(D_in); t.sw = odd_stride(W); t.sg = odd_stride(D_out);
  t.w = smem;
  t.dw = t.w + t.n_w;
  t.x = t.dw + t.n_w;
  t.act = t.x + tile * t.sx;
  t.dl = t.act + H * tile * t.sw;
  t.g = t.dl + H * tile * t.sw;
  return t;
}

// block-wide: this partition's weights (float32 or bfloat16 in device
// memory, hidden slab of n_hid_slab layers) into w as float32, dw zeroed;
// ends with __syncthreads()
template <typename T>
__device__ __forceinline__ void mlp_tile_load(const MlpTile& t,
                                              const T* __restrict__ w_in,
                                              const T* __restrict__ w_hid,
                                              const T* __restrict__ w_out) {
  for (int i = threadIdx.x; i < t.n_w; i += blockDim.x) {
    float v;
    if (i < t.n_in) v = to_f32(w_in[i]);
    else if (i < t.n_in + t.n_hid) v = to_f32(w_hid[i - t.n_in]);
    else v = to_f32(w_out[i - t.n_in - t.n_hid]);
    t.w[i] = v;
    t.dw[i] = 0.0f;
  }
  __syncthreads();
}

// acc[j] += s * w[j], j ascending; w a 16-byte aligned row of W weights
template <int W>
__device__ __forceinline__ void fma_row(float (&acc)[W], float s, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const float4 q = w4[j];
    acc[4 * j] += s * q.x;
    acc[4 * j + 1] += s * q.y;
    acc[4 * j + 2] += s * q.z;
    acc[4 * j + 3] += s * q.w;
  }
}

// sum over j ascending of v[j] * w[j]; w a 16-byte aligned row of W weights
template <int W>
__device__ __forceinline__ float dot_row(const float (&v)[W], const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < W / 4; ++j) {
    const float4 q = w4[j];
    s += v[4 * j] * q.x;
    s += v[4 * j + 1] * q.y;
    s += v[4 * j + 2] * q.z;
    s += v[4 * j + 3] * q.w;
  }
  return s;
}

// thread-local: row r's activations from its x row (act[l][r] for every
// layer); returns nothing, the output is mlp_tile_out
template <int W, bool RB = false>
__device__ __forceinline__ void mlp_tile_forward(const MlpTile& t, int r) {
  const int tile = blockDim.x;
  const float* xr = t.x + r * t.sx;
  float acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0.0f;
  for (int k = 0; k < t.D_in; ++k) fma_row<W>(acc, xr[k], t.w + k * W);
  float* a = t.act + r * t.sw;
#pragma unroll
  for (int j = 0; j < W; ++j) a[j] = round_if<RB>(relu(acc[j]));
  for (int l = 0; l + 1 < t.H; ++l) {
    const float* in = t.act + (l * tile + r) * t.sw;
    float* out = t.act + ((l + 1) * tile + r) * t.sw;
    const float* wl = t.w + t.n_in + l * W * W;
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < W; ++k) fma_row<W>(acc, in[k], wl + k * W);
#pragma unroll
    for (int j = 0; j < W; ++j) out[j] = round_if<RB>(relu(acc[j]));
  }
}

// thread-local: output d of row r (after mlp_tile_forward)
template <int W, bool RB = false>
__device__ __forceinline__ float mlp_tile_out(const MlpTile& t, int r, int d) {
  const float* a = t.act + ((t.H - 1) * blockDim.x + r) * t.sw;
  const float* wo = t.w + t.n_in + t.n_hid;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < W; ++k) s += a[k] * wo[k * t.D_out + d];
  return round_if<RB>(s);
}

// row r's W values of a per-row array into registers
template <int W>
__device__ __forceinline__ void load_w(const float* row, float (&v)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = row[j];
}

// thread-local: row r's deltas from its output cotangent g[r] (ReLU masks
// from the recomputed activations: a unit passes its cotangent where its
// output is > 0; under RB the cotangent is rounded to bfloat16 first); d0
// gets the first layer's deltas, for mlp_tile_dx
template <int W, bool RB = false>
__device__ __forceinline__ void mlp_tile_backward(const MlpTile& t, int r,
                                                  float (&d0)[W]) {
  const int tile = blockDim.x;
  const float* gr = t.g + r * t.sg;
  const float* wo = t.w + t.n_in + t.n_hid;
  {
    const float* a = t.act + ((t.H - 1) * tile + r) * t.sw;
    float* dl = t.dl + ((t.H - 1) * tile + r) * t.sw;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      float s = 0.0f;
      for (int d = 0; d < t.D_out; ++d) s += gr[d] * wo[j * t.D_out + d];
      s = round_if<RB>(s);
      d0[j] = a[j] > 0.0f ? s : 0.0f;
      dl[j] = d0[j];
    }
  }
  for (int l = t.H - 2; l >= 0; --l) {
    const float* a = t.act + (l * tile + r) * t.sw;
    float* dl = t.dl + (l * tile + r) * t.sw;
    const float* wl = t.w + t.n_in + l * W * W;
#pragma unroll 1
    for (int k = 0; k < W; ++k) {
      // d0: the layer above's deltas
      const float s = round_if<RB>(dot_row<W>(d0, wl + k * W));
      dl[k] = a[k] > 0.0f ? s : 0.0f;
    }
    load_w<W>(dl, d0);
  }
}

// thread-local: cotangent of input feature i, from the first layer's
// deltas d0 of mlp_tile_backward, in float32 (the caller rounds it to the
// input's type)
template <int W>
__device__ __forceinline__ float mlp_tile_dx(const MlpTile& t, const float (&d0)[W],
                                             int i) {
  return dot_row<W>(d0, t.w + i * W);
}

// block-wide (call after a __syncthreads() that follows every row's
// backward): dw += this tile's weight gradient over its `rows` rows. A
// thread takes a block of 2 rows x 4 columns of one weight matrix at a
// time and sums its 8 products over the tile's rows in registers: 6
// shared loads per 8 products, where one weight per thread takes 2 per
// product. Each weight's sum runs over the rows in order, as before.
template <int W>
__device__ __forceinline__ void mlp_tile_accumulate(const MlpTile& t, int rows) {
  const int tile = blockDim.x;
  // blocks per matrix: x^T delta_0 (D_in x W), act_l^T delta_{l+1}
  // (W x W each), act_{H-1}^T g (W x D_out)
  const int n_in = (t.D_in + 1) / 2 * (W / 4);
  const int n_hid = W / 2 * (W / 4);
  const int n_out = W / 2 * ((t.D_out + 3) / 4);
  const int total = n_in + (t.H - 1) * n_hid + n_out;
  for (int it = threadIdx.x; it < total; it += tile) {
    const float *A, *D;
    float* dw;
    int sa, sd, n_row, n_col, blk;
    if (it < n_in) {
      blk = it; A = t.x; sa = t.sx; D = t.dl; sd = t.sw;
      n_row = t.D_in; n_col = W; dw = t.dw;
    } else if (it < n_in + (t.H - 1) * n_hid) {
      const int l = (it - n_in) / n_hid;
      blk = (it - n_in) % n_hid;
      A = t.act + l * tile * t.sw; sa = t.sw;
      D = t.dl + (l + 1) * tile * t.sw; sd = t.sw;
      n_row = W; n_col = W; dw = t.dw + t.n_in + l * W * W;
    } else {
      blk = it - n_in - (t.H - 1) * n_hid;
      A = t.act + (t.H - 1) * tile * t.sw; sa = t.sw; D = t.g; sd = t.sg;
      n_row = W; n_col = t.D_out; dw = t.dw + t.n_in + t.n_hid;
    }
    const int col_blocks = (n_col + 3) / 4;
    const int i0 = 2 * (blk / col_blocks), j0 = 4 * (blk % col_blocks);
    const bool two = i0 + 1 < n_row;
    const int nj = min(4, n_col - j0);
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int r = 0; r < rows; ++r) {
      const float* ar = A + r * sa + i0;
      const float* dr = D + r * sd + j0;
      const float a0 = ar[0], a1 = two ? ar[1] : 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float d = jj < nj ? dr[jj] : 0.0f;
        acc[0][jj] += a0 * d;
        acc[1][jj] += a1 * d;
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj >= nj) continue;
      dw[i0 * n_col + j0 + jj] += acc[0][jj];
      if (two) dw[(i0 + 1) * n_col + j0 + jj] += acc[1][jj];
    }
  }
}

// block-wide (after the last tile and a __syncthreads()): dw into the
// partition's float32 gradients in device memory, one atomicAdd per weight
__device__ __forceinline__ void mlp_tile_flush(const MlpTile& t,
                                               float* __restrict__ g_in,
                                               float* __restrict__ g_hid,
                                               float* __restrict__ g_out) {
  for (int i = threadIdx.x; i < t.n_w; i += blockDim.x) {
    float* dst;
    if (i < t.n_in) dst = g_in + i;
    else if (i < t.n_in + t.n_hid) dst = g_hid + (i - t.n_in);
    else dst = g_out + (i - t.n_in - t.n_hid);
    atomicAdd(dst, t.dw[i]);
  }
}

// host: the largest tile (threads per block) of 128 / 64 / 32 whose shared
// memory (the MLP tile plus `extra` floats per row) fits one block; 0 if none
inline int mlp_pick_tile(int D_in, int W, int H, int D_out, int extra,
                         size_t* smem) {
  for (int tile = 128; tile >= 32; tile /= 2) {
    *smem = sizeof(float) *
            (size_t)(mlp_tile_floats(D_in, W, H, D_out, tile) + (long long)extra * tile);
    if (*smem <= 232448) return tile;   // an H100 block's shared-memory limit
  }
  return 0;
}

// host: blocks per batch row (grid.x) so that `rows` rows of blocks fill the
// card's SMs at the occupancy `smem` allows, capped at one block per tile;
// each block walks its row's tiles with a stride of grid.x
inline long long blocks_per_row(long long n_tiles, long long rows, int tile,
                                size_t smem) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long per_sm = 2048 / tile;
  if ((long long)(232448 / smem) < per_sm) per_sm = 232448 / smem;
  if (per_sm < 1) per_sm = 1;
  const long long want = (sms * per_sm + rows - 1) / rows;
  return want < n_tiles ? want : n_tiles;
}

}  // namespace repro

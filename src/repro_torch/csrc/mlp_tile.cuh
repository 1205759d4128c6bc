// One block's tile of rows through the bias-free ReLU MLP, forward and
// backward, with the weight gradients reduced in shared memory: the shared
// core of the MLP backward kernel (fused_mlp.cu) and the fused train step
// (train_step.cu). float32 throughout (the training kernels run the f32
// policy).
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
// The weight gradient of a tile is a sum over its rows. The TPU kernels
// accumulate it with `+=` across an in-order grid; here each thread owns
// weights i = tid, tid + TILE, ... and sums their products over the tile's
// rows into dw (no atomics inside the block); the caller adds dw to the
// global gradient once per block, one atomicAdd per weight.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {

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

// block-wide: this partition's weights into w (hidden slab of n_hid_slab
// layers in device memory), dw zeroed; ends with __syncthreads()
__device__ __forceinline__ void mlp_tile_load(const MlpTile& t,
                                              const float* __restrict__ w_in,
                                              const float* __restrict__ w_hid,
                                              const float* __restrict__ w_out) {
  for (int i = threadIdx.x; i < t.n_w; i += blockDim.x) {
    float v;
    if (i < t.n_in) v = w_in[i];
    else if (i < t.n_in + t.n_hid) v = w_hid[i - t.n_in];
    else v = w_out[i - t.n_in - t.n_hid];
    t.w[i] = v;
    t.dw[i] = 0.0f;
  }
  __syncthreads();
}

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// thread-local: row r's activations from its x row (act[l][r] for every
// layer); returns nothing, the output is mlp_tile_out
template <int W>
__device__ __forceinline__ void mlp_tile_forward(const MlpTile& t, int r) {
  const int tile = blockDim.x;
  const float* xr = t.x + r * t.sx;
  float acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0.0f;
  for (int k = 0; k < t.D_in; ++k) {
    const float xk = xr[k];
    const float* wk = t.w + k * W;
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] += xk * wk[j];
  }
  float* a = t.act + r * t.sw;
#pragma unroll
  for (int j = 0; j < W; ++j) a[j] = relu(acc[j]);
  for (int l = 0; l + 1 < t.H; ++l) {
    const float* in = t.act + (l * tile + r) * t.sw;
    float* out = t.act + ((l + 1) * tile + r) * t.sw;
    const float* wl = t.w + t.n_in + l * W * W;
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < W; ++k) {
      const float hk = in[k];
      const float* wk = wl + k * W;
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] += hk * wk[j];
    }
#pragma unroll
    for (int j = 0; j < W; ++j) out[j] = relu(acc[j]);
  }
}

// thread-local: output d of row r (after mlp_tile_forward)
template <int W>
__device__ __forceinline__ float mlp_tile_out(const MlpTile& t, int r, int d) {
  const float* a = t.act + ((t.H - 1) * blockDim.x + r) * t.sw;
  const float* wo = t.w + t.n_in + t.n_hid;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < W; ++k) s += a[k] * wo[k * t.D_out + d];
  return s;
}

// thread-local: row r's deltas from its output cotangent g[r] (ReLU masks
// from the recomputed activations: a unit passes its cotangent where its
// output is > 0)
template <int W>
__device__ __forceinline__ void mlp_tile_backward(const MlpTile& t, int r) {
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
      dl[j] = a[j] > 0.0f ? s : 0.0f;
    }
  }
  for (int l = t.H - 2; l >= 0; --l) {
    const float* a = t.act + (l * tile + r) * t.sw;
    const float* up = t.dl + ((l + 1) * tile + r) * t.sw;
    float* dl = t.dl + (l * tile + r) * t.sw;
    const float* wl = t.w + t.n_in + l * W * W;
#pragma unroll 1
    for (int k = 0; k < W; ++k) {
      const float* wk = wl + k * W;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < W; ++j) s += up[j] * wk[j];
      dl[k] = a[k] > 0.0f ? s : 0.0f;
    }
  }
}

// thread-local: cotangent of input feature i of row r (after backward)
template <int W>
__device__ __forceinline__ float mlp_tile_dx(const MlpTile& t, int r, int i) {
  const float* d0 = t.dl + r * t.sw;
  const float* wi = t.w + i * W;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < W; ++j) s += d0[j] * wi[j];
  return s;
}

// block-wide (call after a __syncthreads() that follows every row's
// backward): dw += this tile's weight gradient over its `rows` rows
template <int W>
__device__ __forceinline__ void mlp_tile_accumulate(const MlpTile& t, int rows) {
  const int tile = blockDim.x;
  for (int i = threadIdx.x; i < t.n_w; i += blockDim.x) {
    const float *A, *D;
    int sa, sd;
    if (i < t.n_in) {                     // x^T delta_0
      A = t.x + i / W; sa = t.sx;
      D = t.dl + i % W; sd = t.sw;
    } else if (i < t.n_in + t.n_hid) {    // act_l^T delta_{l+1}
      const int ii = i - t.n_in, l = ii / (W * W), rem = ii % (W * W);
      A = t.act + l * tile * t.sw + rem / W; sa = t.sw;
      D = t.dl + (l + 1) * tile * t.sw + rem % W; sd = t.sw;
    } else {                              // act_{H-1}^T g
      const int ii = i - t.n_in - t.n_hid;
      A = t.act + (t.H - 1) * tile * t.sw + ii / t.D_out; sa = t.sw;
      D = t.g + ii % t.D_out; sd = t.sg;
    }
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += A[r * sa] * D[r * sd];
    t.dw[i] += s;
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

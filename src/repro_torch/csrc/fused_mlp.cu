// Fused bias-free ReLU MLP, forward and backward, for a batch of input rows
// against partition-stacked weights.
//
// ---- forward ----
//
// Replaces: src/repro/kernels/fused_mlp/kernel.py, fused_mlp_fwd_pallas (the
// pallas_call at line 71, body _fwd_kernel). The TPU kernel pins the weights
// in VMEM and runs (BLOCK_N, D_in) tiles through the layer stack on the MXU.
// Here a block loads the weights of its batch row's partition into shared
// memory once (PRODUCTION256: 20x16 + 16x16 + 16x1 floats, under 3 KB), and
// each thread runs one input row through every layer on chip: a layer's sums
// are accumulated in registers and its ReLU outputs parked in the thread's
// column of shared memory for the next layer. No hidden activation is ever
// written to device memory.
//
// Bound: bytes at the widths DVNR uses. Per row it reads D_in values and
// writes D_out; at D_in=20, W=16, two hidden layers it does 2 x 592
// multiply-adds against 84 B moved (about 14 flop per byte, below the f32
// ridge of ~20 flop/B on an H100), so the design streams rows once and keeps
// everything else on chip. The products run on the CUDA cores in float32 (a
// W=16 layer is too narrow to fill a wgmma tile; tensor cores come later).
//
// Numerics: float32 accumulation; for bfloat16 inputs each layer's ReLU
// output is rounded to bfloat16 before the next layer, as the JAX reference
// (bf16 in, bf16 out per matmul) does. ReLU is max(h, 0) with NaN passed
// through, like jnp.maximum.
//
// ---- backward ----
//
// Replaces: src/repro/kernels/fused_mlp/kernel.py, fused_mlp_bwd_pallas (line
// 88; the pallas_call at line 93, body _bwd_kernel at line 32). The TPU kernel
// recomputes the activations of a (BLOCK_N, D_in) tile on the MXU and adds
// the tile's dW into whole-array output blocks with `+=`, which is safe only
// because its grid runs in order. Here a block of TILE threads walks tiles
// of its batch row (one row per thread) with the weights in shared memory,
// recomputes the activations, runs the layer stack backwards per row, writes
// dx, and sums the tile's dW over its rows in shared memory (mlp_tile.cuh:
// each thread owns a set of weights, so there are no atomics inside the
// block); after its last tile the block adds its dW to the partition's
// float32 gradient with one atomicAdd per weight.
//
// Bound: bytes and operations are close. Per row it reads D_in + D_out and
// writes D_in floats and does about 3 x 2 x (D_in W + (H-1) W^2 + W D_out)
// flops (forward, delta, dW): at PRODUCTION256's widths 164 B against about
// 3,550 flop, 22 flop/B, at the f32 ridge of an H100. The products run on
// the CUDA cores from shared memory (W = 16 is too narrow for a wgmma tile);
// the dW pass reads two shared-memory operands per product, so shared-memory
// bandwidth, not the bound, is the likely limit of this version. The atomic
// adds make dW's last bits vary from run to run.
//
// bfloat16 operands (fused_mlp_bwd_kernel<__nv_bfloat16>, the bf16 training
// policy): x, the cotangent and the weights are read as bfloat16 and
// widened; the recomputed activations are rounded to bfloat16 as the forward
// rounds them, and each layer's delta is rounded to bfloat16 before its ReLU
// mask, where the plain version's autograd rounds it (fused_mlp/ref.py); dx
// is summed in float32 and rounded once to bfloat16; dW is summed in float32
// into the float32 gradient (the autograd function rounds it once to the
// weights' type). JAX's kernel sums dW in bfloat16 per grid tile
// (kernel.py:110-112).
#include "common.cuh"
#include "mlp_tile.cuh"

namespace {

template <typename T, int W>
__global__ void fused_mlp_fwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ w_in,
                                     const T* __restrict__ w_hid,
                                     const T* __restrict__ w_out,
                                     const int* __restrict__ part,
                                     T* __restrict__ out, long long N, int D_in,
                                     int n_hidden, int n_hid_slab, int D_out) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const long long p = __ldg(part + b);
  const int n_in = D_in * W, n_hid = (n_hidden - 1) * W * W, n_out = W * D_out;
  float* s_in = smem;
  float* s_hid = s_in + n_in;
  float* s_out = s_hid + n_hid;
  // this thread's activations, column-major across the block: s_act[k * blockDim.x
  // + threadIdx.x] holds unit k, so the block's reads of one unit hit 32 banks
  float* s_act = s_out + n_out;
  const T* g_in = w_in + p * n_in;
  const T* g_hid = w_hid + p * (long long)n_hid_slab * W * W;
  const T* g_out = w_out + p * n_out;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) s_in[i] = repro::to_f32(g_in[i]);
  for (int i = threadIdx.x; i < n_hid; i += blockDim.x) s_hid[i] = repro::to_f32(g_hid[i]);
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) s_out[i] = repro::to_f32(g_out[i]);
  __syncthreads();

  float* act = s_act + threadIdx.x;
  const int st = blockDim.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const T* xr = x + ((long long)b * N + n) * D_in;
    float g[W];
#pragma unroll
    for (int j = 0; j < W; ++j) g[j] = 0.0f;
    for (int k = 0; k < D_in; ++k) {
      const float xk = repro::to_f32(xr[k]);
      const float* wk = s_in + k * W;
#pragma unroll
      for (int j = 0; j < W; ++j) g[j] += xk * wk[j];
    }
#pragma unroll
    for (int j = 0; j < W; ++j) act[j * st] = repro::round_to<T>(g[j] < 0.0f ? 0.0f : g[j]);
    for (int layer = 0; layer < n_hidden - 1; ++layer) {
      const float* wl = s_hid + layer * W * W;
#pragma unroll
      for (int j = 0; j < W; ++j) g[j] = 0.0f;
#pragma unroll 1
      for (int k = 0; k < W; ++k) {
        const float hk = act[k * st];
        const float* wk = wl + k * W;
#pragma unroll
        for (int j = 0; j < W; ++j) g[j] += hk * wk[j];
      }
#pragma unroll
      for (int j = 0; j < W; ++j) act[j * st] = repro::round_to<T>(g[j] < 0.0f ? 0.0f : g[j]);
    }
    T* o = out + ((long long)b * N + n) * D_out;
    for (int d = 0; d < D_out; ++d) {
      float s = 0.0f;
#pragma unroll 1
      for (int k = 0; k < W; ++k) s += act[k * st] * s_out[k * D_out + d];
      o[d] = repro::from_f32<T>(s);
    }
  }
}

template <typename T, int W>
cudaError_t launch_w(const void* x, const void* w_in, const void* w_hid,
                     const void* w_out, const int* part, void* out, long long B,
                     long long N, int D_in, int n_hidden, int n_hid_slab,
                     int D_out, cudaStream_t stream) {
  auto kernel = fused_mlp_fwd_kernel<T, W>;
  const int threads = 128;
  const size_t smem =
      sizeof(float) * ((size_t)D_in * W + (size_t)(n_hidden - 1) * W * W +
                       (size_t)W * D_out + (size_t)W * threads);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  long long blocks = (N + threads - 1) / threads;
  if (blocks > 8192) blocks = 8192;  // grid-stride beyond: weights load once per block
  const dim3 grid((unsigned)blocks, (unsigned)B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_hid), static_cast<const T*>(w_out), part,
      static_cast<T*>(out), N, D_in, n_hidden, n_hid_slab, D_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w_in, const void* w_hid,
                   const void* w_out, const int* part, void* out, long long B,
                   long long N, int D_in, int W, int n_hidden, int n_hid_slab,
                   int D_out, cudaStream_t s) {
  switch (W) {
    case 16: return launch_w<T, 16>(x, w_in, w_hid, w_out, part, out, B, N, D_in, n_hidden, n_hid_slab, D_out, s);
    case 32: return launch_w<T, 32>(x, w_in, w_hid, w_out, part, out, B, N, D_in, n_hidden, n_hid_slab, D_out, s);
    case 64: return launch_w<T, 64>(x, w_in, w_hid, w_out, part, out, B, N, D_in, n_hidden, n_hid_slab, D_out, s);
    default: return cudaErrorInvalidValue;
  }
}

// the backward for operands of type T: float (the float32 policy) or
// __nv_bfloat16 (the bf16 policy, float32 dW)
template <typename T, int W>
__global__ void fused_mlp_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w_in,
    const T* __restrict__ w_hid, const T* __restrict__ w_out,
    const T* __restrict__ gout, const int* __restrict__ part,
    T* __restrict__ dx, float* __restrict__ dw_in, float* __restrict__ dw_hid,
    float* __restrict__ dw_out, long long N, int D_in, int n_hidden,
    int n_hid_slab, int D_out) {
  constexpr bool RB = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const long long p = __ldg(part + b);
  const repro::MlpTile t =
      repro::mlp_tile_carve(smem, D_in, W, n_hidden, D_out, blockDim.x);
  const long long hid_off = p * (long long)n_hid_slab * W * W;
  repro::mlp_tile_load<T>(t, w_in + p * t.n_in, w_hid + hid_off,
                          w_out + p * t.n_out);
  const int r = threadIdx.x;
  const long long n_tiles = (N + blockDim.x - 1) / blockDim.x;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long n = tile * blockDim.x + r;
    const bool valid = n < N;
    const long long row = (long long)b * N + n;
    // rows past N take zeros: finite activations and zero deltas, so the
    // block-wide dW pass may sum over the whole tile
    for (int k = 0; k < D_in; ++k)
      t.x[r * t.sx + k] = valid ? repro::to_f32(x[row * D_in + k]) : 0.0f;
    for (int d = 0; d < D_out; ++d)
      t.g[r * t.sg + d] = valid ? repro::to_f32(gout[row * D_out + d]) : 0.0f;
    repro::mlp_tile_forward<W, RB>(t, r);
    float d0[W];
    repro::mlp_tile_backward<W, RB>(t, r, d0);
    if (valid)
      for (int i = 0; i < D_in; ++i)
        dx[row * D_in + i] = repro::from_f32<T>(repro::mlp_tile_dx<W>(t, d0, i));
    __syncthreads();
    repro::mlp_tile_accumulate<W>(t, blockDim.x);
    __syncthreads();
  }
  repro::mlp_tile_flush(t, dw_in + p * t.n_in, dw_hid + hid_off,
                        dw_out + p * t.n_out);
}

template <typename T, int W>
cudaError_t launch_bwd_w(const void* x, const void* w_in, const void* w_hid,
                         const void* w_out, const void* g, const int* part,
                         void* dx, float* dw_in, float* dw_hid, float* dw_out,
                         long long B, long long N, int D_in, int n_hidden,
                         int n_hid_slab, int D_out, cudaStream_t stream) {
  const auto kernel = fused_mlp_bwd_kernel<T, W>;
  size_t smem = 0;
  const int tile = repro::mlp_pick_tile(D_in, W, n_hidden, D_out, 0, &smem);
  if (tile == 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n_tiles = (N + tile - 1) / tile;
  const dim3 grid((unsigned)repro::blocks_per_row(n_tiles, B, tile, smem), (unsigned)B);
  kernel<<<grid, tile, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_hid), static_cast<const T*>(w_out),
      static_cast<const T*>(g), part, static_cast<T*>(dx), dw_in, dw_hid,
      dw_out, N, D_in, n_hidden, n_hid_slab, D_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w_in, const void* w_hid,
                       const void* w_out, const void* g, const int* part, void* dx,
                       float* dw_in, float* dw_hid, float* dw_out, long long B,
                       long long N, int D_in, int W, int n_hidden, int n_hid_slab,
                       int D_out, cudaStream_t s) {
  switch (W) {
    case 16: return launch_bwd_w<T, 16>(x, w_in, w_hid, w_out, g, part, dx, dw_in, dw_hid, dw_out, B, N, D_in, n_hidden, n_hid_slab, D_out, s);
    case 32: return launch_bwd_w<T, 32>(x, w_in, w_hid, w_out, g, part, dx, dw_in, dw_hid, dw_out, B, N, D_in, n_hidden, n_hid_slab, D_out, s);
    case 64: return launch_bwd_w<T, 64>(x, w_in, w_hid, w_out, g, part, dx, dw_in, dw_hid, dw_out, B, N, D_in, n_hidden, n_hid_slab, D_out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,N,D_in); w_in (P,D_in,W); w_hid (P,n_hid_slab,W,W) with
// n_hid_slab = max(n_hidden-1, 1) (the slab is a dummy when n_hidden == 1);
// w_out (P,W,D_out); part (B,) i32 -> out (B,N,D_out), all in one type;
// 0 <= part[b] < P is checked on the host.
extern "C" int repro_fused_mlp_fwd(const void* x, const void* w_in,
                                   const void* w_hid, const void* w_out,
                                   const void* part, void* out, long long B,
                                   long long N, int D_in, int W, int n_hidden,
                                   int n_hid_slab, int D_out, int is_bf16,
                                   void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535 || n_hidden < 1) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, w_in, w_hid, w_out, p, out, B, N, D_in, W, n_hidden, n_hid_slab, D_out, s)
                       : launch<float>(x, w_in, w_hid, w_out, p, out, B, N, D_in, W, n_hidden, n_hid_slab, D_out, s));
}

// x (B,N,D_in), w_in (P,D_in,W), w_hid (P,n_hid_slab,W,W), w_out (P,W,D_out),
// g (B,N,D_out), all float32 (is_bf16 = 0) or all bfloat16 (is_bf16 = 1);
// part (B,) i32 -> dx (B,N,D_in) in the operands' type and dW summed over
// each partition's rows into the float32 dw_in / dw_hid / dw_out (same
// shapes as the weights, zeroed by the caller); 0 <= part[b] < P is checked
// on the host.
extern "C" int repro_fused_mlp_bwd(const void* x, const void* w_in,
                                   const void* w_hid, const void* w_out,
                                   const void* g, const void* part, void* dx,
                                   void* dw_in, void* dw_hid, void* dw_out,
                                   long long B, long long N, int D_in, int W,
                                   int n_hidden, int n_hid_slab, int D_out,
                                   int is_bf16, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535 || n_hidden < 1) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(part);
  float* di = static_cast<float*>(dw_in);
  float* dh = static_cast<float*>(dw_hid);
  float* dout = static_cast<float*>(dw_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch_bwd<__nv_bfloat16>(x, w_in, w_hid, w_out, g, p, dx, di, dh, dout, B, N, D_in, W, n_hidden, n_hid_slab, D_out, s)
      : launch_bwd<float>(x, w_in, w_hid, w_out, g, p, dx, di, dh, dout, B, N, D_in, W, n_hidden, n_hid_slab, D_out, s));
}

// Fused bias-free ReLU MLP, forward and backward, for a batch of input rows
// against partition-stacked weights.
//
// ---- forward ----
//
// Replaces: src/repro/kernels/fused_mlp/kernel.py, fused_mlp_fwd_pallas (the
// pallas_call at line 71, body _fwd_kernel). The TPU kernel pins the weights
// in VMEM and runs (BLOCK_N, D_in) tiles through the layer stack on the MXU.
// Here each block loads its batch row's partition weights into shared
// memory once, already laid out as tensor-core B fragments, and each warp
// walks 32-row tiles of the row with a grid stride: the tile's rows x D_in
// values are one contiguous stretch of x, copied into a padded shared-memory
// tile with cp.async (16-byte copies where D_in is a multiple of 4, 8 or 4
// bytes for other even widths) while the warp runs the previous tile, and
// the rows go through every layer on the tensor cores (mlp_mma.cuh: mma.sync
// m16n8k16 on bf16 operands, 3xTF32 m16n8k8 on float32 ones; each layer's
// accumulators re-packed in registers as the next layer's operands). No
// hidden activation leaves the registers. This is the unfused route: the
// INR inference path runs inr_forward.cu instead.
//
// Bound: bytes. Per row it reads D_in values and writes D_out; at
// PRODUCTION256's widths (D_in=20, W=16, two hidden layers, D_out=1) that is
// 84 B against 2 x 592 multiply-adds in float32: 14 flop a byte, under the
// f32 ridge of an H100 (~20 flop/B), and the 3 tf32 products per multiply-add
// run far under the tensor cores' rate. So the design keeps the copies in
// flight (two tiles per warp) and everything else on chip. Padding K to the
// mma's k and D_out to n = 8 costs tensor-core work, not bytes. On the H100
// at a serving tick's shapes the copies alone and the float32 products
// alone each take about two thirds of the kernel's time: the 3xTF32 splits
// and the mma.sync chains cost instructions and latency that 32 resident
// warps do not fully hide behind the copies.
//
// Numerics: float32 sums. bfloat16 operands: exact bf16 products summed in
// float32, each layer's ReLU output rounded to bfloat16 before the next
// layer, as the JAX reference (bf16 in, bf16 out per matmul) does. float32
// operands: 3xTF32 keeps ~22 bits of each operand (the tail product a_lo
// b_lo, ~2^-22 relative, is dropped), so results differ from float32 FMAs
// in the last bits, as FMAs in another order do. ReLU is max(h, 0) with NaN
// passed through, like jnp.maximum.
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
#include "mlp_mma.cuh"
#include "mlp_tile.cuh"

namespace {

namespace mm = repro::mma;

// one asynchronous copy of `bytes` (16, 8 or 4) from device memory into
// shared memory; 2 bytes (a bf16 row of odd width) are copied in place
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
      break;
    default:
      *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
  }
}

// blocks of 256 threads an SM must hold, which caps the registers at
// 65536 / (256 x blocks): the occupancy each instantiation reaches without
// spilling (ptxas would otherwise trade spills for the next block)
template <typename T, int W>
constexpr int fwd_min_blocks() {
  constexpr bool h = sizeof(T) == 2;
  return W == 16 ? 4 : W == 32 ? (h ? 3 : 2) : (h ? 2 : 1);
}

template <typename T, int W>
__global__ void __launch_bounds__(256, fwd_min_blocks<T, W>()) fused_mlp_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w_in, const T* __restrict__ w_hid,
    const T* __restrict__ w_out, const int* __restrict__ part, T* __restrict__ out,
    long long N, int D_in, int n_hidden, int n_hid_slab, int D_out) {
  extern __shared__ __align__(16) float smem[];   // one declaration per file
  const mm::Shape s{D_in, n_hidden, D_out};
  const int b = blockIdx.y;
  const long long p = __ldg(part + b);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  mm::load_weights<T, W>(sw, w_in + p * D_in * W, w_hid + p * n_hid_slab * W * W,
                         w_out + p * W * D_out, s);
  // two input tiles per warp, after the weights
  const int stride = mm::tile_stride(D_in), tile_elems = mm::TILE_ROWS * stride;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* buf = reinterpret_cast<T*>(sw + mm::weight_words<T>(D_in, W, n_hidden)) +
           (size_t)warp * 2 * tile_elems;
  for (int i = lane; i < 2 * tile_elems; i += 32) buf[i] = repro::from_f32<T>(0.0f);
  __syncthreads();   // the weights, and the zeros before any copy lands

  // a tile's rows are one stretch of x, copied in units of V values that
  // never straddle a row (V divides D_in; x starts 16-byte aligned). Unit u
  // lies in row u / upr (upr units a row), taken as a multiply and a shift
  // (exact for u < 32 upr, upr < 8192)
  const int V = D_in % 4 == 0 ? 4 : D_in % 2 == 0 ? 2 : 1;
  const int bytes = V * (int)sizeof(T), upr = D_in / V;
  const unsigned magic = ((1u << 26) + upr - 1) / upr;
  const long long row0 = (long long)b * N;
  auto fetch = [&](long long tile, T* dst) {
    const long long n0 = tile * mm::TILE_ROWS;
    const int rows = (int)min((long long)mm::TILE_ROWS, N - n0);
    const T* src = x + (row0 + n0) * D_in;
    for (int u = lane; u < rows * upr; u += 32) {
      const int r = (int)(((unsigned)u * magic) >> 26);
      copy_async(dst + r * stride + (u - r * upr) * V, src + u * V, bytes);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const long long n_tiles = (N + mm::TILE_ROWS - 1) / mm::TILE_ROWS;
  const long long step = (long long)gridDim.x * warps;
  long long tile = (long long)blockIdx.x * warps + warp;
  if (tile < n_tiles) fetch(tile, buf);
  for (int cur = 0; tile < n_tiles; tile += step, cur ^= 1) {
    if (tile + step < n_tiles) {
      fetch(tile + step, buf + (cur ^ 1) * tile_elems);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();   // every lane's copies of this tile have landed
    const long long n0 = tile * mm::TILE_ROWS;
    // one m-tile at a time under float32 (3xTF32's split operands) and at
    // W = 64: the copy pipeline's state leaves no room for two
    mm::tile_forward<T, W, sizeof(T) == 4 || W == 64 ? 1 : 2>(
                           sw, buf + cur * tile_elems, stride, s,
                           out + (row0 + n0) * D_out,
                           (int)min((long long)mm::TILE_ROWS, N - n0));
    __syncwarp();   // read before the next copies overwrite it
  }
}

template <typename T, int W>
cudaError_t launch_w(const void* x, const void* w_in, const void* w_hid,
                     const void* w_out, const int* part, void* out, long long B,
                     long long N, int D_in, int n_hidden, int n_hid_slab,
                     int D_out, cudaStream_t stream) {
  auto kernel = fused_mlp_fwd_kernel<T, W>;
  size_t smem = 0;
  const int warps = mm::pick_warps(
      (size_t)mm::weight_words<T>(D_in, W, n_hidden) * 4,
      2 * sizeof(T) * mm::TILE_ROWS * mm::tile_stride(D_in), &smem);
  if (warps == 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n_tiles = (N + mm::TILE_ROWS - 1) / mm::TILE_ROWS;
  const dim3 grid(
      (unsigned)mm::grid_x((const void*)kernel, warps * 32, smem, n_tiles, warps, B),
      (unsigned)B);
  kernel<<<grid, warps * 32, smem, stream>>>(
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
// w_out (P,W,D_out) with D_out <= 8; part (B,) i32 -> out (B,N,D_out), all
// in one type; x starts 16-byte aligned; 0 <= part[b] < P is checked on the host. Returns
// cudaErrorInvalidValue for shapes the kernel does not take (the weights'
// fragments and one warp's two tiles above 227 KB).
extern "C" int repro_fused_mlp_fwd(const void* x, const void* w_in,
                                   const void* w_hid, const void* w_out,
                                   const void* part, void* out, long long B,
                                   long long N, int D_in, int W, int n_hidden,
                                   int n_hid_slab, int D_out, int is_bf16,
                                   void* stream) {
  if (B <= 0 || N <= 0 || D_out <= 0) return 0;
  if (B > 65535 || n_hidden < 1 || D_out > 8 || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
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

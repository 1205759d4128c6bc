// INR inference in one kernel: the multi-resolution hash encode of each
// coordinate row, straight into a tile of shared memory, then the bias-free
// ReLU MLP on the tensor cores. The path of decode, evaluate and render.
//
// Replaces hash_encode_pallas (src/repro/kernels/hash_encoding/kernel.py:62)
// and fused_mlp_fwd_pallas (src/repro/kernels/fused_mlp/kernel.py:66) in one
// pass. The TPU runs them as two pallas_calls with the (N, L*F) feature
// array in HBM between them; so did the port's first route (hash_encode.cu
// then fused_mlp.cu), which writes and reads back 80 bytes of features a
// point (5.4 GB per serving tick at PRODUCTION256's widths).
//
// Design. A block loads its batch row's partition weights once, as B
// fragments (mlp_mma.cuh), and each warp walks 32-row tiles of the row with
// a grid stride. For a tile, each lane takes one point and all its levels
// in turn: the level geometry and the 8-corner gather of hash_grid.cuh
// (level_geom, gather_corners: one vector load per corner row; coarse dense
// levels from L1, hashed rows from L2), each level's F features stored into
// the lane's row of the warp's tile in shared memory. The warp then runs the
// tile through the MLP (mma.sync; each layer's accumulators re-packed in
// registers as the next layer's operands) and writes D_out values a row.
// One point per thread with all its levels lost as the hash-encode forward
// (hash_encode.cu) because its 16-byte stores scattered across a warp's
// stretch of device memory; here they land in shared memory, and every
// lane of a warp works on the same level at once.
//
// Bound: 16 bytes a point (the coordinates in, one float32 out) against
// the float work of the encode (~450 flop a point at PRODUCTION256: 5 levels
// of geometry and 8 weighted corner rows) and the MLP's products (1,184 flop
// a point; on the tensor cores under bf16). At a serving tick's 67.1M
// points: 0.32 ms by bytes, ~1.6 ms by float32 operations. What sets the
// pace is instructions: the encode's geometry and corner rows (as in
// hash_encode.cu, now without the feature array's round trip) and, under
// float32, the MLP's 3xTF32 products, which on the H100 at a serving tick's
// shapes take about half the kernel's time each.
//
// Numerics, the two-kernel route's exactly, up to the MLP's sum order: the
// geometry of hash_grid.cuh (lower corner clamped, offset not, so rays that
// miss the box extrapolate), each corner weight rounded to the table type,
// the blend summed in float32 and rounded once to the table type. The
// wrapper casts the tables and weights to the compute dtype first, as the
// route's _cast does, so the table type is the compute type. Then the MLP
// of mlp_mma.cuh (bf16: float32 sums of exact products, each hidden ReLU
// output rounded to bfloat16; float32: 3xTF32), the output rounded to the
// compute type.
#include "common.cuh"
#include "hash_grid.cuh"
#include "mlp_mma.cuh"

namespace {

namespace mm = repro::mma;

constexpr int MAX_LEVELS = 32;

// blocks of 256 threads an SM must hold, which caps the registers at
// 65536 / (256 x blocks): the occupancy each instantiation reaches without
// spilling (ptxas would otherwise trade spills for the next block)
template <typename T, int W, int F>
constexpr int inr_min_blocks() {
  constexpr bool h = sizeof(T) == 2;
  return W == 16 ? (!h && F == 8 ? 3 : 4) : W == 32 ? (h ? 3 : 2) : (h ? 2 : 1);
}

template <typename T, int W, int F>
__global__ void __launch_bounds__(256, inr_min_blocks<T, W, F>()) inr_forward_kernel(
    const float* __restrict__ coords, const T* __restrict__ tables,
    const int* __restrict__ res, const int* __restrict__ part,
    const T* __restrict__ w_in, const T* __restrict__ w_hid,
    const T* __restrict__ w_out, T* __restrict__ out, long long N, int L,
    long long T_size, int n_hidden, int n_hid_slab, int D_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D_in = L * F;
  const mm::Shape s{D_in, n_hidden, D_out};
  const int b = blockIdx.y;
  const long long p = __ldg(part + b);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  mm::load_weights<T, W>(sw, w_in + p * D_in * W, w_hid + p * n_hid_slab * W * W,
                         w_out + p * W * D_out, s);
  int* s_res = reinterpret_cast<int*>(sw + mm::weight_words<T>(D_in, W, n_hidden));
  for (int i = threadIdx.x; i < L; i += blockDim.x) s_res[i] = __ldg(res + i);
  // one tile per warp, after the weights and the resolutions
  const int stride = mm::tile_stride(D_in), tile_elems = mm::TILE_ROWS * stride;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* tile = reinterpret_cast<T*>(s_res + MAX_LEVELS) + (size_t)warp * tile_elems;
  for (int i = lane; i < tile_elems; i += 32) tile[i] = repro::from_f32<T>(0.0f);
  __syncthreads();

  const T* tab = tables + p * L * T_size * F;
  const long long row0 = (long long)b * N;
  T* row = tile + lane * stride;
  const long long n_tiles = (N + mm::TILE_ROWS - 1) / mm::TILE_ROWS;
  const long long step = (long long)gridDim.x * warps;
  for (long long t = (long long)blockIdx.x * warps + warp; t < n_tiles; t += step) {
    const long long n0 = t * mm::TILE_ROWS, n = n0 + lane;
    if (n < N) {   // rows past N keep stale features; their outputs are dropped
      const float* c = coords + (row0 + n) * 3;
      const float cc[3] = {__ldg(c), __ldg(c + 1), __ldg(c + 2)};
      for (int l = 0; l < L; ++l) {
        const repro::LevelGeom geo = repro::level_geom(cc, s_res[l], T_size);
        float acc[F];
        repro::gather_corners<T, F>(geo, tab + (long long)l * T_size * F, acc);
        repro::store_row<T, F>(row + l * F, acc);
      }
    }
    __syncwarp();   // the tile's rows are every lane's
    mm::tile_forward<T, W, W == 64 ? 1 : 2>(sw, tile, stride, s, out + (row0 + n0) * D_out,
                           (int)min((long long)mm::TILE_ROWS, N - n0));
    __syncwarp();   // read before the next tile's features overwrite it
  }
}

template <typename T, int W, int F>
cudaError_t launch_wf(const float* coords, const void* tables, const int* res,
                      const int* part, const void* w_in, const void* w_hid,
                      const void* w_out, void* out, long long B, long long N,
                      int L, long long T_size, int n_hidden, int n_hid_slab,
                      int D_out, cudaStream_t stream) {
  auto kernel = inr_forward_kernel<T, W, F>;
  const int D_in = L * F;
  size_t smem = 0;
  const int warps = mm::pick_warps(
      (size_t)mm::weight_words<T>(D_in, W, n_hidden) * 4 + MAX_LEVELS * sizeof(int),
      sizeof(T) * mm::TILE_ROWS * mm::tile_stride(D_in), &smem);
  if (warps == 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n_tiles = (N + mm::TILE_ROWS - 1) / mm::TILE_ROWS;
  const dim3 grid(
      (unsigned)mm::grid_x((const void*)kernel, warps * 32, smem, n_tiles, warps, B),
      (unsigned)B);
  REPRO_NOTE_LAUNCH(kernel, smem);
  kernel<<<grid, warps * 32, smem, stream>>>(
      coords, static_cast<const T*>(tables), res, part, static_cast<const T*>(w_in),
      static_cast<const T*>(w_hid), static_cast<const T*>(w_out), static_cast<T*>(out),
      N, L, T_size, n_hidden, n_hid_slab, D_out);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_w(int F, const float* coords, const void* tables, const int* res,
                     const int* part, const void* w_in, const void* w_hid,
                     const void* w_out, void* out, long long B, long long N, int L,
                     long long T_size, int n_hidden, int n_hid_slab, int D_out,
                     cudaStream_t s) {
  switch (F) {
    case 1: return launch_wf<T, W, 1>(coords, tables, res, part, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s);
    case 2: return launch_wf<T, W, 2>(coords, tables, res, part, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s);
    case 4: return launch_wf<T, W, 4>(coords, tables, res, part, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s);
    case 8: return launch_wf<T, W, 8>(coords, tables, res, part, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(int W, int F, const float* coords, const void* tables,
                   const int* res, const int* part, const void* w_in,
                   const void* w_hid, const void* w_out, void* out, long long B,
                   long long N, int L, long long T_size, int n_hidden,
                   int n_hid_slab, int D_out, cudaStream_t s) {
  switch (W) {
    case 16: return launch_w<T, 16>(F, coords, tables, res, part, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s);
    case 32: return launch_w<T, 32>(F, coords, tables, res, part, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s);
    case 64: return launch_w<T, 64>(F, coords, tables, res, part, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// coords (B,N,3) f32; tables (P,L,T,F), 16-byte aligned; res (L,) i32 on the
// device; part (B,) i32; w_in (P,L*F,W), w_hid (P,n_hid_slab,W,W) with
// n_hid_slab = max(n_hidden-1, 1), w_out (P,W,D_out) -> out (B,N,D_out);
// tables, weights and out in one type (float32 when is_bf16 = 0, else
// bfloat16). F in {1,2,4,8}, W in {16,32,64}, L <= 32, D_out <= 8,
// 0 <= part[b] < P checked on the host; cudaErrorInvalidValue for shapes
// the kernel does not take (the weights' fragments and one warp's tile
// above 227 KB).
extern "C" int repro_inr_forward(const void* coords, const void* tables,
                                 const void* res, const void* part, const void* w_in,
                                 const void* w_hid, const void* w_out, void* out,
                                 long long B, long long N, int L, long long T_size,
                                 int F, int W, int n_hidden, int n_hid_slab,
                                 int D_out, int is_bf16, void* stream) {
  if (B <= 0 || N <= 0 || D_out <= 0) return 0;
  if (B > 65535 || L < 1 || L > MAX_LEVELS || n_hidden < 1 || D_out > 8 ||
      T_size < 1 || T_size >= (1LL << 32) ||
      reinterpret_cast<uintptr_t>(tables) % 16)
    return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  const int* r = static_cast<const int*>(res);
  const int* p = static_cast<const int*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch<__nv_bfloat16>(W, F, c, tables, r, p, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s)
      : launch<float>(W, F, c, tables, r, p, w_in, w_hid, w_out, out, B, N, L, T_size, n_hidden, n_hid_slab, D_out, s));
}

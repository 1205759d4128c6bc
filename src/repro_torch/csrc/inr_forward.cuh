// INR inference in one kernel: the multi-resolution hash encode of each
// coordinate row into a tile of shared memory, then the bias-free ReLU MLP
// on the tensor cores. The path of decode, evaluate and render. The C
// entries and the float32 instantiations are in inr_forward.cu, the bf16
// ones in inr_forward_bf16.cu (two translation units that nvcc compiles
// side by side).
//
// Replaces hash_encode_pallas (src/repro/kernels/hash_encoding/kernel.py:62)
// and fused_mlp_fwd_pallas (src/repro/kernels/fused_mlp/kernel.py:66) in one
// pass. The TPU runs them as two pallas_calls with the (N, L*F) feature
// array in HBM between them; so did the port's first route (hash_encode.cu
// then fused_mlp.cu), which writes and reads back 80 bytes of features a
// point (5.4 GB per serving tick at PRODUCTION256's widths).
//
// Bound: 16 bytes a point (the coordinates in, one float32 out) against
// the float work of the encode (~450 flop a point at PRODUCTION256: 5 levels
// of geometry and 8 weighted corner rows) and the MLP's products (1,184 flop
// a point; on the tensor cores under bf16). At a serving tick's 67.1M
// points: 0.32 ms by bytes, ~1.6 ms by float32 operations. What sets the
// pace are the corner gathers: 40 row loads a point from scattered rows,
// which the L1 serves a distinct line at a time. The stage clock below
// (chip_smoke.py phase 6) puts 71% of the warps' cycles in the gathers under
// float32 and 86% under bf16, a hashed level at ~1.15x a dense one, and the
// MLP at 25% and 10%.
//
// Design (inr_forward_kernel): persistent blocks, one an SM (mm::grid_x
// one_wave), each holding as many warps as the one-warp design held an SM
// (32 at W = 16). Block k takes the k-th contiguous range of the (batch
// row, 32-row tile) sequence; at each batch row it enters (a segment) it
// loads that partition's MLP weights once, as B fragments, and copies the
// partition's rows of the levels the plan stages into shared memory, one
// bulk copy a level (cp.async.bulk, completing on an mbarrier). Each warp
// then takes the segment's tiles in turn: each lane encodes one point
// through every level (hash_grid.cuh: level_geom, the 8-corner gather from
// the staged rows in shared memory or from device memory through the
// read-only path, each level's F features stored into the lane's row of
// the warp's tile), and the warp runs the tile through the MLP (mlp_mma.cuh:
// mma.sync, bf16 m16n8k16 or 3xTF32; each layer's accumulators re-packed in
// registers as the next layer's operands), D_out values a row out. The plan
// (plan_layout, fwd_plan in ops.py) stages levels in order while their rows
// fit beside every warp's tile: at PRODUCTION256 all five under bf16
// (177,232 B), the three dense ones under float32 (92,272 B). Staged, a
// gather is a shared-memory load whose bank conflicts cost less than the
// L1's line-at-a-time service, and the hashed rows no longer evict the
// dense ones from the L1. The plan is made on the host, and a launch asks
// for the layout's own shared bytes, so that the L1 keeps the rest for the
// levels left in device memory: the SM's 256 KiB are split in steps (196
// KiB of shared memory leave the L1 60 KiB, 228 leave it 28), and a level
// is staged beyond the 196 KiB step only where every level then is (the
// L1 measured worth more than staging one more level, chip_smoke.py phase
// 6: up to 1.6x at ABLATION's widths).
//
// The yardstick (inr_forward_grid_kernel, phase 6 only): the one-warp
// design before it, at the configs' widths (W = 16, F = 4 and W = 64,
// F = 8): blocks of 8 warps, as many an SM as their registers allow, on a
// grid-stride loop, every level from device memory.
//
// Numerics, the two-kernel route's exactly, up to the MLP's sum order: the
// geometry of hash_grid.cuh (lower corner clamped, offset not, so rays that
// miss the box extrapolate), each corner weight rounded to the table type,
// the blend summed in float32 and rounded once to the table type; a staged
// row holds the device row's bits, so every plan gives the same output bit
// for bit. The wrapper casts the tables and weights to the compute dtype
// first, as the route's _cast does, so the table type is the compute type.
// Then the MLP of mlp_mma.cuh (bf16: float32 sums of exact products, each
// hidden ReLU output rounded to bfloat16; float32: 3xTF32), the output
// rounded to the compute type.
#pragma once

#include "common.cuh"
#include "hash_grid.cuh"
#include "hopper.cuh"
#include "mlp_mma.cuh"

namespace repro {
namespace inr {

namespace mm = repro::mma;
namespace hp = repro::hopper;

constexpr int MAX_LEVELS = 32;
constexpr int SMEM_LIMIT = 232448;
// the most dynamic shared memory a block takes while some level stays in
// device memory: 195 KiB, with the KiB CUDA reserves a block, the 196 KiB
// carve-out (the L1 60 KiB); one byte more takes the 228 KiB one (28 KiB)
constexpr int SMEM_KEEP_L1 = 195 * 1024;

// ------------------------------------------------------------ the clock
// Where a warp's time goes, by stage: the level geometry and corner gathers
// of dense and of hashed levels, the feature stores into the tile, the
// MLP's products and the output stores. InrNoClock records nothing;
// InrStageClock adds the cycles since its last mark to a stage's count,
// and its flush adds the warp's counts and then its lifetime in ns (the
// global timer) to a global array of kStages + 1.
enum Stage { kDense, kHashed, kStore, kMlp, kOut, kStages };

struct InrNoClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

struct InrStageClock {
  long long last;
  unsigned long long born;
  unsigned t[kStages];
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < kStages; ++i) t[i] = 0;
    born = mm::global_ns();
    last = clock64();
  }
  __device__ __forceinline__ void mark(int s) {
    const long long now = clock64();
    t[s] += (unsigned)(now - last);
    last = now;
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < kStages; ++i) atomicAdd(out + i, (unsigned long long)t[i]);
      atomicAdd(out + kStages, mm::global_ns() - born);
    }
  }
};

// one lane's point through every level into its row of the tile (rows past
// N are not written: they keep stale features and their outputs are dropped)
template <typename T, int F, typename Clk>
__device__ __forceinline__ void encode_row(const float* c, const T* tab, const int* s_res,
                                           int L, long long T_size, unsigned staged,
                                           const unsigned char* smem, const int* tab_off,
                                           T* row, Clk& clk) {
  const float cc[3] = {__ldg(c), __ldg(c + 1), __ldg(c + 2)};
  for (int l = 0; l < L; ++l) {
    const repro::LevelGeom geo = repro::level_geom(cc, s_res[l], T_size);
    float acc[F];
    if (staged >> l & 1)
      repro::gather_corners_shared<T, F>(
          geo, reinterpret_cast<const T*>(smem + tab_off[l]), acc);
    else
      repro::gather_corners<T, F>(geo, tab + (long long)l * T_size * F, acc);
    if (geo.dense)   // (the stage a compile-time index: the counts stay in registers)
      clk.mark(kDense);
    else
      clk.mark(kHashed);
    repro::store_row<T, F>(row + l * F, acc);
    clk.mark(kStore);
  }
}

// the MLP of a 32-row tile and its outputs (mm::tile_forward with the
// clock's marks between products and stores)
template <typename T, int W, int MT, typename Clk>
__device__ __forceinline__ void mlp_tile(const uint32_t* sw, const T* tile, int stride,
                                         const mm::Shape& s, T* out_rows, int n_valid,
                                         Clk& clk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int pass = 0; pass < mm::TILE_ROWS / (16 * MT); ++pass) {
    float o[MT][4];
    mm::forward<T, W, MT>(sw, tile + pass * 16 * MT * stride, stride, s, o);
    clk.mark(kMlp);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = (pass * MT + m) * 16 + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r + (i >> 1) * 8, col = c + (i & 1);
        if (row < n_valid && col < s.D_out)
          out_rows[(size_t)row * s.D_out + col] = repro::from_f32<T>(o[m][i]);
      }
    }
    clk.mark(kOut);
  }
}

// ---------------------------------------------------------- staged levels
__host__ __device__ __forceinline__ long long round16(long long v) { return (v + 15) / 16 * 16; }

// the bytes a staged level takes: its rows of F values, rounded up to 16
template <typename T>
__host__ __device__ __forceinline__ long long level_bytes(int res, long long T_size, int F) {
  return round16(repro::level_rows(res, T_size) * F * (long long)sizeof(T));
}

// a level's rows start 16-byte aligned in the table (the bulk copy's rule)
template <typename T>
__host__ __device__ __forceinline__ bool stageable(long long T_size, int F) {
  return (T_size * F * (long long)sizeof(T)) % 16 == 0;
}

// One thread: the partition's staged levels (tab: its tables) into shared
// memory, one bulk copy a level, completing on tbar
template <typename T>
__device__ __forceinline__ void copy_levels(unsigned char* smem, const T* tab, uint64_t* tbar,
                                            unsigned staged, int staged_bytes,
                                            const int* tab_off, const int* s_res, int L,
                                            long long T_size, int F) {
  hp::mbar_expect_tx(tbar, (unsigned)staged_bytes);
  for (int l = 0; l < L; ++l)
    if (staged >> l & 1)
      hp::bulk_copy_g2s(smem + tab_off[l], tab + (long long)l * T_size * F,
                        (unsigned)level_bytes<T>(s_res[l], T_size, F), tbar);
}

// ------------------------------------------------------ the main design
// The block at width W and F features: as many warps as the one-warp
// design held an SM without spilling, or fewer where the persistent loop's
// own registers would spill (the registers a thread its launch bound
// leaves: 64 at W = 16, 80 at F = 8 under float32; 128 at W = 32; W = 64
// 128 / 255), and the m16 tiles the MLP runs side by side.
template <typename T, int W, int F>
struct Block {
  static constexpr bool H = sizeof(T) == 2;
  static constexpr int THREADS = W == 16 ? (!H && F == 8 ? 768 : 1024)
                               : W == 32 ? 512 : (H ? 512 : 256);
  static constexpr int MT = W == 64 ? 1 : 2;
};

// A launch's use of the block's shared memory (byte offsets): the weights'
// fragments, the resolutions and each level's offset (32 ints each), the
// tables' barrier, the staged levels' rows, one 32-row tile a warp; the
// launch asks for `bytes`.
struct Layout {
  unsigned staged;   // bit l: level l staged
  int warps;         // warps with a tile (< 1: the kernel does not take the shape)
  int res_off, bar_off, tab_off, tile_off, bytes, staged_bytes;
};

// The levels' resolutions and the byte offset of each staged level's rows
// in shared memory (a kernel parameter, read where it lies)
struct Levels {
  int res[MAX_LEVELS];
  int off[MAX_LEVELS];
};

// The layout at these shapes (res in host memory; lv, where given, takes
// the resolutions and offsets). force < 0: the rule (fwd_plan): levels in
// order, each staged if its rows fit what is left of the budget: the room
// beside the weights and every warp's tile where every level fits it, else
// that room within SMEM_KEEP_L1; force >= 0: the levels of that mask. A
// level whose rows do not start 16-byte aligned in the table is never
// staged. Then as many warps as fit, up to the block's.
template <typename T, int W, int F>
Layout plan_layout(const int* res, int L, long long T_size, int n_hidden, long long force,
                   Levels* lv = nullptr) {
  constexpr int NW = Block<T, W, F>::THREADS / 32;
  const int D_in = L * F;
  Layout lay{};
  lay.res_off = mm::weight_words<T>(D_in, W, n_hidden) * 4;
  lay.bar_off = lay.res_off + 8 * MAX_LEVELS;
  lay.tab_off = lay.bar_off + 16;
  const long long tile = (long long)mm::TILE_ROWS * mm::tile_stride(D_in) * sizeof(T);
  const bool ok = stageable<T>(T_size, F);
  const long long fixed = lay.tab_off + NW * tile;
  long long every = 0, chosen = 0;
  for (int l = 0; l < L; ++l) every += level_bytes<T>(res[l], T_size, F);
  long long budget = SMEM_LIMIT - fixed;
  if (every > budget && SMEM_KEEP_L1 - fixed < budget) budget = SMEM_KEEP_L1 - fixed;
  unsigned mask = 0;
  for (int l = 0; l < L && ok; ++l) {
    const long long b = level_bytes<T>(res[l], T_size, F);
    const bool take = force < 0 ? b <= budget : (force >> l & 1) != 0;
    if (take) {
      if (lv) lv->off[l] = lay.tab_off + (int)chosen;
      mask |= 1u << l;
      chosen += b;
      budget -= b;
    }
  }
  for (int l = 0; lv && l < L; ++l) lv->res[l] = res[l];
  const long long room = SMEM_LIMIT - lay.tab_off - chosen;
  const long long warps = room >= 0 ? room / tile : 0;
  lay.warps = (int)(warps < NW ? warps : NW);
  lay.staged = mask;
  lay.staged_bytes = (int)chosen;
  lay.tile_off = lay.tab_off + (int)chosen;
  lay.bytes = lay.tile_off + (int)(tile * (lay.warps > 0 ? lay.warps : 0));
  return lay;
}

template <typename T, int W, int F, typename Clk>
__global__ void __launch_bounds__(Block<T, W, F>::THREADS, 1) inr_forward_kernel(
    const float* __restrict__ coords, const T* __restrict__ tables,
    const int* __restrict__ part, const T* __restrict__ w_in,
    const T* __restrict__ w_hid, const T* __restrict__ w_out, T* __restrict__ out,
    long long B, long long N, int L, long long T_size, int n_hidden, int n_hid_slab,
    int D_out, const Layout lay, const __grid_constant__ Levels lv,
    unsigned long long* __restrict__ clocks) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D_in = L * F;
  const mm::Shape s{D_in, n_hidden, D_out};
  // the resolutions and the staged levels' offsets after the weights'
  // fragments
  int* s_res = reinterpret_cast<int*>(smem + lay.res_off);
  int* tab_off = s_res + MAX_LEVELS;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    s_res[i] = lv.res[i];
    tab_off[i] = lv.off[i];
  }
  uint64_t* tbar = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  if (threadIdx.x == 0) {
    hp::mbar_init(tbar, 1);
    hp::mbar_init_fence();
  }
  const int stride = mm::tile_stride(D_in), tile_elems = mm::TILE_ROWS * stride;
  T* tile = reinterpret_cast<T*>(smem + lay.tile_off) + (size_t)warp * tile_elems;
  const bool works = warp < lay.warps;
  if (works)   // the padding columns are read as zero by the MLP
    for (int i = lane; i < tile_elems; i += 32) tile[i] = repro::from_f32<T>(0.0f);
  __syncthreads();

  // the block's tiles, [first, last) of the (batch row, tile) sequence, as
  // rows b_first..b_last and tiles within a row (32-bit: few registers
  // stay live across the MLP)
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  const int tpr = (int)((N + mm::TILE_ROWS - 1) / mm::TILE_ROWS);
  const long long total = B * tpr;
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  const int b_first = (int)(first / tpr), b_last = (int)((last - 1) / tpr);
  const int r_first = (int)(first - (long long)b_first * tpr);
  const int r_last = (int)(last - (long long)b_last * tpr);
  Clk clk;
  clk.start();
  for (int b = b_first; b <= b_last && first < last; ++b) {
    const long long p = __ldg(part + b);
    if (b > b_first) {   // every warp is done with the last row's weights and levels
      hp::fence_proxy_async_shared();
      __syncthreads();
    }
    mm::load_weights<T, W>(sw, w_in + p * D_in * W, w_hid + p * n_hid_slab * W * W,
                           w_out + p * W * D_out, s);
    const T* tab = tables + p * L * T_size * F;
    if (threadIdx.x == 0 && lay.staged)
      copy_levels<T>(smem, tab, tbar, lay.staged, lay.staged_bytes, tab_off, s_res, L,
                     T_size, F);
    __syncthreads();   // the weights
    if (works) {
      if (lay.staged) hp::mbar_wait(tbar, (b - b_first) & 1);
      const float* crow = coords + (long long)b * N * 3;
      T* orow = out + (long long)b * N * D_out;
      const int r_end = b == b_last ? r_last : tpr;
      for (int r = (b == b_first ? r_first : 0) + warp; r < r_end; r += lay.warps) {
        const long long n0 = (long long)r * mm::TILE_ROWS;
        const int rows = (int)min((long long)mm::TILE_ROWS, N - n0);
        if (lane < rows)
          encode_row<T, F>(crow + (n0 + lane) * 3, tab, s_res, L, T_size, lay.staged, smem,
                           tab_off, tile + lane * stride, clk);
        __syncwarp();   // the tile's rows are every lane's
        mlp_tile<T, W, Block<T, W, F>::MT>(sw, tile, stride, s, orow + n0 * D_out, rows,
                                           clk);
        __syncwarp();   // read before the next tile's features overwrite it
      }
    }
  }
  if (works) clk.flush(clocks);
}

// ------------------------------------------------- the grid yardstick
// blocks of 256 threads an SM must hold, which caps the registers at
// 65536 / (256 x blocks): the occupancy each width reaches without spilling
template <typename T, int W, int F>
constexpr int grid_min_blocks() {
  constexpr bool h = sizeof(T) == 2;
  return W == 16 ? (!h && F == 8 ? 3 : 4) : W == 32 ? (h ? 3 : 2) : (h ? 2 : 1);
}

template <typename T, int W, int F, typename Clk>
__global__ void __launch_bounds__(256, grid_min_blocks<T, W, F>()) inr_forward_grid_kernel(
    const float* __restrict__ coords, const T* __restrict__ tables,
    const int* __restrict__ part, const T* __restrict__ w_in,
    const T* __restrict__ w_hid, const T* __restrict__ w_out, T* __restrict__ out,
    long long N, int L, long long T_size, int n_hidden, int n_hid_slab, int D_out,
    const __grid_constant__ Levels lv, unsigned long long* __restrict__ clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D_in = L * F;
  const mm::Shape s{D_in, n_hidden, D_out};
  const int b = blockIdx.y;
  const long long p = __ldg(part + b);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  mm::load_weights<T, W>(sw, w_in + p * D_in * W, w_hid + p * n_hid_slab * W * W,
                         w_out + p * W * D_out, s);
  int* s_res = reinterpret_cast<int*>(sw + mm::weight_words<T>(D_in, W, n_hidden));
  for (int i = threadIdx.x; i < L; i += blockDim.x) s_res[i] = lv.res[i];
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
  Clk clk;
  clk.start();
  for (long long t = (long long)blockIdx.x * warps + warp; t < n_tiles; t += step) {
    const long long n0 = t * mm::TILE_ROWS, n = n0 + lane;
    if (n < N)
      encode_row<T, F>(coords + (row0 + n) * 3, tab, s_res, L, T_size, 0u, smem, nullptr,
                       row, clk);
    __syncwarp();   // the tile's rows are every lane's
    mlp_tile<T, W, Block<T, W, F>::MT>(sw, tile, stride, s, out + (row0 + n0) * D_out,
                                       (int)min((long long)mm::TILE_ROWS, N - n0), clk);
    __syncwarp();   // read before the next tile's features overwrite it
  }
  clk.flush(clocks);
}

// ------------------------------------------------------------- launches
// A launch's operands. occupancy: null to launch, else three int64 that
// take the blocks an SM holds, the block's threads and its dynamic shared
// bytes, and nothing is launched.
struct Args {
  const float* coords;
  const void* tables;
  const int* res;   // host memory
  const int* part;
  const void *w_in, *w_hid, *w_out;
  void* out;
  long long B, N;
  int L;
  long long T_size;
  int n_hidden, n_hid_slab, D_out;
  long long force;
  unsigned long long* clocks;
  long long* occupancy;
  cudaStream_t stream;
};

inline cudaError_t occupancy_of(const void* kernel, int threads, int smem, long long* out) {
  int per_sm = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  out[0] = per_sm;
  out[1] = threads;
  out[2] = smem;
  return e;
}

template <typename T, int W, int F, typename Clk>
cudaError_t launch_main(const Args& a) {
  constexpr int THREADS = Block<T, W, F>::THREADS;
  auto kernel = inr_forward_kernel<T, W, F, Clk>;
  Levels lv{};
  const Layout lay = plan_layout<T, W, F>(a.res, a.L, a.T_size, a.n_hidden, a.force, &lv);
  if (lay.warps < 1) return cudaErrorInvalidValue;   // a forced plan that leaves no room
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (e != cudaSuccess) return e;
  if (a.occupancy) return occupancy_of((const void*)kernel, THREADS, lay.bytes, a.occupancy);
  const long long total = a.B * ((a.N + mm::TILE_ROWS - 1) / mm::TILE_ROWS);
  const long long grid =
      mm::grid_x((const void*)kernel, THREADS, lay.bytes, total, 1, 1, true);
  REPRO_NOTE_LAUNCH(kernel, lay.bytes);
  kernel<<<(unsigned)grid, THREADS, lay.bytes, a.stream>>>(
      a.coords, static_cast<const T*>(a.tables), a.part, static_cast<const T*>(a.w_in),
      static_cast<const T*>(a.w_hid), static_cast<const T*>(a.w_out),
      static_cast<T*>(a.out), a.B, a.N, a.L, a.T_size, a.n_hidden, a.n_hid_slab, a.D_out,
      lay, lv, a.clocks);
  return cudaGetLastError();
}

template <typename T, int W, int F, typename Clk>
cudaError_t launch_grid(const Args& a) {
  auto kernel = inr_forward_grid_kernel<T, W, F, Clk>;
  const int D_in = a.L * F;
  size_t smem = 0;
  const int warps = mm::pick_warps(
      (size_t)mm::weight_words<T>(D_in, W, a.n_hidden) * 4 + MAX_LEVELS * sizeof(int),
      sizeof(T) * mm::TILE_ROWS * mm::tile_stride(D_in), &smem);
  if (warps == 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (a.occupancy) return occupancy_of((const void*)kernel, warps * 32, (int)smem, a.occupancy);
  const long long n_tiles = (a.N + mm::TILE_ROWS - 1) / mm::TILE_ROWS;
  const dim3 grid(
      (unsigned)mm::grid_x((const void*)kernel, warps * 32, smem, n_tiles, warps, a.B),
      (unsigned)a.B);
  Levels lv{};
  for (int l = 0; l < a.L; ++l) lv.res[l] = a.res[l];
  REPRO_NOTE_LAUNCH(kernel, smem);
  kernel<<<grid, warps * 32, smem, a.stream>>>(
      a.coords, static_cast<const T*>(a.tables), a.part, static_cast<const T*>(a.w_in),
      static_cast<const T*>(a.w_hid), static_cast<const T*>(a.w_out),
      static_cast<T*>(a.out), a.N, a.L, a.T_size, a.n_hidden, a.n_hid_slab, a.D_out, lv,
      a.clocks);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t main_w(int F, const Args& a) {
  switch (F) {
    case 1: return launch_main<T, W, 1, InrNoClock>(a);
    case 2: return launch_main<T, W, 2, InrNoClock>(a);
    case 4: return launch_main<T, W, 4, InrNoClock>(a);
    case 8: return launch_main<T, W, 8, InrNoClock>(a);
    default: return cudaErrorInvalidValue;
  }
}

// One dtype's launches (F in {1, 2, 4, 8} and W in {16, 32, 64} checked by
// the caller): design 0 the main design at every width, 1 the grid
// yardstick at W = 16, F = 4 and W = 64, F = 8; with clocks, the clocked
// instantiation of either at W = 16, F = 4.
template <typename T>
cudaError_t dispatch(int W, int F, int design, const Args& a) {
  const bool tick = W == 16 && F == 4;
  if (a.clocks) {
    if (!tick) return cudaErrorInvalidValue;
    return design == 1 ? launch_grid<T, 16, 4, InrStageClock>(a)
                       : launch_main<T, 16, 4, InrStageClock>(a);
  }
  if (design == 1) {
    if (tick) return launch_grid<T, 16, 4, InrNoClock>(a);
    if (W == 64 && F == 8) return launch_grid<T, 64, 8, InrNoClock>(a);
    return cudaErrorInvalidValue;
  }
  switch (W) {
    case 16: return main_w<T, 16>(F, a);
    case 32: return main_w<T, 32>(F, a);
    case 64: return main_w<T, 64>(F, a);
    default: return cudaErrorInvalidValue;
  }
}

// the two translation units' instantiations of dispatch
cudaError_t dispatch_f32(int W, int F, int design, const Args& a);
cudaError_t dispatch_bf16(int W, int F, int design, const Args& a);

}  // namespace inr
}  // namespace repro

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
// because its grid runs in order. Here, as in the forward, a block loads its
// batch row's partition weights into shared memory once (as B fragments,
// the forward's and the transposed ones) and each warp walks 32-row tiles
// of the row with a grid stride, its x rows and cotangent rows copied into
// shared memory with cp.async one tile ahead. For each pass of rows
// (mlp_mma.cuh bwd_pass) the warp recomputes the activations, runs the
// delta chain and dx on the tensor cores and adds the pass's dW, also on
// the tensor cores (the rows as the mma's k), to its own float32 dW in
// shared memory. dx goes back over the tile's x rows and leaves it as
// coalesced 16-byte stores (8 or 4 bytes where D_in allows no more). After
// its last tile the block sums its warps' dW and adds it to the
// partition's float32 gradient with one atomicAdd per weight.
//
// Bound: operations under float32, bytes under bf16. Per row it reads D_in
// + D_out values and writes D_in and does 3 x 2 x (D_in W + (H-1) W^2 + W
// D_out) flop (forward, deltas and dx, dW): at PRODUCTION256's widths 164 B
// (f32) against about 3,550 flop, 22 flop/B, at the f32 ridge of an H100;
// on the tensor cores (3xTF32: three tf32 products each) the products are
// far under their peak, and what sets the pace is the instructions around
// them: the operands' splits, the fragments' shared-memory loads and the
// mma.sync chains. The atomic adds make dW's last bits vary from run to run.
//
// The deterministic route (torch.use_deterministic_algorithms(True): the
// wrapper calls repro_fused_mlp_bwd_det) runs the same kernel on a grid
// whose blocks a batch row depend on N alone (det_blocks: at most
// DET_BLOCKS, never the SM count or the number of rows), so every warp
// takes the same tiles whatever else is launched beside it; each block
// writes its dW (its warps' sums, in warp order) to a row of its own, and
// mlp_dw_reduce_kernel sums a partition's rows in (batch row, block)
// order into the gradient. dx is row-local on both routes.
//
// Numerics, as the plain version (fused_mlp/ref.py): bfloat16 operands
// (fused_mlp_bwd_kernel<__nv_bfloat16>, the bf16 training policy): exact
// products summed in float32; the recomputed activations rounded to
// bfloat16 as the forward rounds them; each layer's delta rounded to
// bfloat16 before its ReLU mask, where the plain version's autograd rounds
// it; dx summed in float32 and rounded once to bfloat16; dW summed in
// float32 into the float32 gradient (the autograd function rounds it once
// to the weights' type). JAX's kernel sums dW in bfloat16 per grid tile
// (kernel.py:110-112). float32 operands: 3xTF32 (about 22 bits of each
// operand), so a pre-activation within about 2^-21 of the sum of its
// |products| from 0 may take the other ReLU mask than the plain version's
// float32 sums; both are derivatives of the ReLU at a tie.
#include "common.cuh"
#include "mlp_mma.cuh"

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

// `bytes` (16, 8, 4 or 2) from shared memory to device memory, both
// aligned to it
__device__ __forceinline__ void copy_out(void* dst, const void* src, int bytes) {
  switch (bytes) {
    case 16: *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src); break;
    case 8: *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src); break;
    case 4: *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src); break;
    default: *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
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
  REPRO_NOTE_LAUNCH(kernel, smem);
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

// blocks of 256 threads an SM must hold (see fwd_min_blocks): two where
// shared memory lets two in (bf16 at W = 16), else one
template <typename T, int W>
constexpr int bwd_min_blocks() {
  return sizeof(T) == 2 && W == 16 ? 2 : 1;
}

// the backward for operands of type T: float (the float32 policy) or
// __nv_bfloat16 (the bf16 policy, float32 dW); Clk (mlp_mma.cuh) marks its
// stages, into `clocks` for mm::StageClock
template <typename T, int W, typename Clk>
__global__ void __launch_bounds__(256, bwd_min_blocks<T, W>()) fused_mlp_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w_in,
    const T* __restrict__ w_hid, const T* __restrict__ w_out,
    const T* __restrict__ gout, const int* __restrict__ part,
    T* __restrict__ dx, float* __restrict__ dw_in, float* __restrict__ dw_hid,
    float* __restrict__ dw_out, long long N, int D_in, int n_hidden,
    int n_hid_slab, int D_out, float* __restrict__ partials,
    unsigned long long* __restrict__ clocks) {
  using C = mm::Bwd<T, W>;
  extern __shared__ __align__(16) float smem[];
  const mm::Shape s{D_in, n_hidden, D_out};
  const mm::BwdLayout lay = mm::bwd_layout<T, W>(D_in, n_hidden, D_out);
  const int b = blockIdx.y;
  const long long p = __ldg(part + b);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  mm::load_weights_bwd<T, W>(sw, lay, w_in + p * D_in * W,
                             w_hid + p * n_hid_slab * W * W, w_out + p * W * D_out, s);
  // the warp's region (bwd_layout): dW, two x tiles, two g tiles, the
  // activation and delta tiles
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* regions = reinterpret_cast<unsigned char*>(sw + lay.words);
  float* dw = reinterpret_cast<float*>(regions + (size_t)warp * lay.warp_bytes);
  const int xs = lay.xs, GS = lay.gs;
  T* xb = reinterpret_cast<T*>(dw + lay.dw_tiles * 128);
  T* gb = xb + 2 * mm::TILE_ROWS * xs;
  T* act = gb + 2 * mm::TILE_ROWS * GS;
  T* dl = act + n_hidden * C::RP * C::AS;
  for (int i = lane; i < lay.dw_tiles * 128; i += 32) dw[i] = 0.0f;
  for (int i = lane; i < 2 * mm::TILE_ROWS * (xs + GS); i += 32)
    xb[i] = repro::from_f32<T>(0.0f);
  __syncthreads();   // the weights, and the zeros before any copy lands
  Clk clk;
  clk.start();

  // a tile's rows of x (of g) are one stretch, copied in units of V (Vg)
  // values that never straddle a row, as the forward copies x; the
  // cotangent rows past the batch are zeroed, so that those rows' deltas
  // and dW terms are zero
  const int V = D_in % 4 == 0 ? 4 : D_in % 2 == 0 ? 2 : 1;
  const int bytes = V * (int)sizeof(T), upr = D_in / V;
  const unsigned magic = ((1u << 26) + upr - 1) / upr;
  const int Vg = D_out % 4 == 0 ? 4 : D_out % 2 == 0 ? 2 : 1;
  const int gbytes = Vg * (int)sizeof(T), gpr = D_out / Vg;
  const long long row0 = (long long)b * N;
  auto fetch = [&](long long tile, int buf) {
    const long long n0 = tile * mm::TILE_ROWS;
    const int rows = (int)min((long long)mm::TILE_ROWS, N - n0);
    T* xd = xb + buf * mm::TILE_ROWS * xs;
    const T* xsrc = x + (row0 + n0) * D_in;
    for (int u = lane; u < rows * upr; u += 32) {
      const int r = (int)(((unsigned)u * magic) >> 26);
      copy_async(xd + r * xs + (u - r * upr) * V, xsrc + u * V, bytes);
    }
    T* gd = gb + buf * mm::TILE_ROWS * GS;
    const T* gsrc = gout + (row0 + n0) * D_out;
    for (int u = lane; u < rows * gpr; u += 32) {
      const int r = u / gpr;
      copy_async(gd + r * GS + (u - r * gpr) * Vg, gsrc + u * Vg, gbytes);
    }
    for (int i = rows * GS + lane; i < mm::TILE_ROWS * GS; i += 32)
      gd[i] = repro::from_f32<T>(0.0f);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // dx rows leave in units of Vo values (16 bytes where D_in allows)
  const int Vo = sizeof(T) == 2 && D_in % 8 == 0 ? 8 : V;
  const int obytes = Vo * (int)sizeof(T), opr = D_in / Vo;
  const long long n_tiles = (N + mm::TILE_ROWS - 1) / mm::TILE_ROWS;
  const long long step = (long long)gridDim.x * warps;
  long long tile = (long long)blockIdx.x * warps + warp;
  if (tile < n_tiles) fetch(tile, 0);
  for (int cur = 0; tile < n_tiles; tile += step, cur ^= 1) {
    if (tile + step < n_tiles) {
      fetch(tile + step, cur ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();   // every lane's copies and zeros of this tile have landed
    clk.mark(mm::kStageWait);
    const long long n0 = tile * mm::TILE_ROWS;
    const int rows = (int)min((long long)mm::TILE_ROWS, N - n0);
    T* xt = xb + cur * mm::TILE_ROWS * xs;
    const T* gt = gb + cur * mm::TILE_ROWS * GS;
#pragma unroll 1
    for (int pass = 0; pass < mm::TILE_ROWS / C::RP; ++pass)
      mm::bwd_pass<T, W>(sw, lay, xt + pass * C::RP * xs, gt + pass * C::RP * GS, act,
                         dl, dw, s, clk);
    __syncwarp();   // dx is in the x rows
    T* dst = dx + (row0 + n0) * D_in;
    for (int u = lane; u < rows * opr; u += 32) {
      const int r = u / opr;
      copy_out(dst + u * Vo, xt + r * xs + (u - r * opr) * Vo, obytes);
    }
    __syncwarp();   // read before the next copies overwrite it
    clk.mark(mm::kStageOut);
  }
  __syncthreads();
  // the block's dW: its warps' C-fragment tiles summed, each weight added
  // to the partition's gradient once (the deterministic route: the sums
  // written to the block's own row of partials, in C-fragment order)
  const float* dws = reinterpret_cast<const float*>(regions);
  const int wf = lay.warp_bytes / 4, in_tiles = lay.mi * C::NT;
  const int hid_tiles = C::MW * C::NT, out_tile0 = in_tiles + (n_hidden - 1) * hid_tiles;
  float* det_row = partials == nullptr ? nullptr
      : partials + ((long long)b * gridDim.x + blockIdx.x) * (lay.dw_tiles * 128);
  for (int e = threadIdx.x; e < lay.dw_tiles * 128; e += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < warps; ++w) v += dws[(size_t)w * wf + e];
    if (det_row != nullptr) {
      det_row[e] = v;
      continue;
    }
    // element i of lane ln's C fragment of tile `tile`: row r, column c
    const int tile_i = e >> 7, ln = (e >> 2) & 31, i = e & 3;
    const int r = (ln >> 2) + (i >> 1) * 8, c = 2 * (ln & 3) + (i & 1);
    if (tile_i < in_tiles) {
      const int k = tile_i / C::NT * 16 + r, n = tile_i % C::NT * 8 + c;
      if (k < D_in) atomicAdd(dw_in + (p * D_in + k) * W + n, v);
    } else if (tile_i < out_tile0) {
      const int l = (tile_i - in_tiles) / hid_tiles, q = (tile_i - in_tiles) % hid_tiles;
      const int k = q / C::NT * 16 + r, n = q % C::NT * 8 + c;
      atomicAdd(dw_hid + ((p * n_hid_slab + l) * W + k) * W + n, v);
    } else if (c < D_out) {
      const int k = (tile_i - out_tile0) * 16 + r;
      atomicAdd(dw_out + (p * W + k) * D_out + c, v);
    }
  }
  clk.mark(mm::kStageReduce);
  clk.flush(clocks);
}

// The deterministic route's blocks a batch row: enough for the row's
// tiles, at most DET_BLOCKS; a function of N and the warps a block (the
// shapes) only. 64 fills the card at the training shapes (8 rows: 512
// blocks, about the default route's one wave of two to four blocks an SM).
constexpr int DET_BLOCKS = 64;
inline long long det_blocks(long long N, int warps) {
  const long long n_tiles = (N + mm::TILE_ROWS - 1) / mm::TILE_ROWS;
  const long long need = (n_tiles + warps - 1) / warps;
  return need < DET_BLOCKS ? need : DET_BLOCKS;
}

// The deterministic route's reduction: dW entry e of partition p is the sum,
// in float32 from 0, of column e of the rows of partials (B, blocks, E)
// whose batch row reads partition p, batch row after batch row and block
// after block; one thread an (p, e), each weight written by one thread (the
// C-fragment element e maps to one weight, or to padding)
__global__ void mlp_dw_reduce_kernel(const float* __restrict__ partials,
                                     const int* __restrict__ part,
                                     float* __restrict__ dw_in,
                                     float* __restrict__ dw_hid,
                                     float* __restrict__ dw_out, long long B,
                                     int blocks, int E, long long P, int D_in, int W,
                                     int n_hidden, int n_hid_slab, int D_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * E) return;
  const long long p = i / E;
  const int e = (int)(i - p * E);
  float v = 0.0f;
  for (long long b = 0; b < B; ++b) {
    if (__ldg(part + b) != p) continue;
    const float* x = partials + b * blocks * E + e;
    for (int k = 0; k < blocks; ++k) v = __fadd_rn(v, x[(long long)k * E]);
  }
  const int NT = W / 8, MW = W / 16, mi = (D_in + 15) / 16;
  const int in_tiles = mi * NT, hid_tiles = MW * NT;
  const int out_tile0 = in_tiles + (n_hidden - 1) * hid_tiles;
  const int tile_i = e >> 7, ln = (e >> 2) & 31, j = e & 3;
  const int r = (ln >> 2) + (j >> 1) * 8, c = 2 * (ln & 3) + (j & 1);
  if (tile_i < in_tiles) {
    const int k = tile_i / NT * 16 + r, n = tile_i % NT * 8 + c;
    if (k < D_in) dw_in[(p * D_in + k) * W + n] = v;
  } else if (tile_i < out_tile0) {
    const int l = (tile_i - in_tiles) / hid_tiles, q = (tile_i - in_tiles) % hid_tiles;
    const int k = q / NT * 16 + r, n = q % NT * 8 + c;
    dw_hid[((p * n_hid_slab + l) * W + k) * W + n] = v;
  } else if (c < D_out) {
    const int k = (tile_i - out_tile0) * 16 + r;
    dw_out[(p * W + k) * D_out + c] = v;
  }
}

template <typename T, int W, typename Clk = mm::NoClock>
cudaError_t launch_bwd_w(const void* x, const void* w_in, const void* w_hid,
                         const void* w_out, const void* g, const int* part,
                         void* dx, float* dw_in, float* dw_hid, float* dw_out,
                         long long B, long long N, int D_in, int n_hidden,
                         int n_hid_slab, int D_out, cudaStream_t stream,
                         unsigned long long* clocks = nullptr,
                         float* partials = nullptr, long long P = 0) {
  const auto kernel = fused_mlp_bwd_kernel<T, W, Clk>;
  const mm::BwdLayout lay = mm::bwd_layout<T, W>(D_in, n_hidden, D_out);
  size_t smem = 0;
  const int warps = mm::bwd_pick_warps((size_t)lay.words * 4, lay.warp_bytes, &smem);
  if (warps == 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long n_tiles = (N + mm::TILE_ROWS - 1) / mm::TILE_ROWS;
  const long long blocks = partials != nullptr
      ? det_blocks(N, warps)
      : mm::grid_x((const void*)kernel, warps * 32, smem, n_tiles, warps, B, true);
  const dim3 grid((unsigned)blocks, (unsigned)B);
  REPRO_NOTE_LAUNCH(kernel, smem);
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(w_hid), static_cast<const T*>(w_out),
      static_cast<const T*>(g), part, static_cast<T*>(dx), dw_in, dw_hid,
      dw_out, N, D_in, n_hidden, n_hid_slab, D_out, partials, clocks);
  e = cudaGetLastError();
  if (e != cudaSuccess || partials == nullptr) return e;
  const int E = lay.dw_tiles * 128;
  REPRO_NOTE_LAUNCH(mlp_dw_reduce_kernel, 0);
  mlp_dw_reduce_kernel<<<(unsigned)((P * E + 255) / 256), 256, 0, stream>>>(
      partials, part, dw_in, dw_hid, dw_out, B, (int)blocks, E, P, D_in, W, n_hidden,
      n_hid_slab, D_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w_in, const void* w_hid,
                       const void* w_out, const void* g, const int* part, void* dx,
                       float* dw_in, float* dw_hid, float* dw_out, long long B,
                       long long N, int D_in, int W, int n_hidden, int n_hid_slab,
                       int D_out, cudaStream_t s, float* partials = nullptr,
                       long long P = 0) {
  switch (W) {
    case 16: return launch_bwd_w<T, 16>(x, w_in, w_hid, w_out, g, part, dx, dw_in, dw_hid, dw_out, B, N, D_in, n_hidden, n_hid_slab, D_out, s, nullptr, partials, P);
    case 32: return launch_bwd_w<T, 32>(x, w_in, w_hid, w_out, g, part, dx, dw_in, dw_hid, dw_out, B, N, D_in, n_hidden, n_hid_slab, D_out, s, nullptr, partials, P);
    case 64: return launch_bwd_w<T, 64>(x, w_in, w_hid, w_out, g, part, dx, dw_in, dw_hid, dw_out, B, N, D_in, n_hidden, n_hid_slab, D_out, s, nullptr, partials, P);
    default: return cudaErrorInvalidValue;
  }
}

// (blocks a batch row, floats a block's row) of the deterministic route's
// partials for these shapes: partials is (B, blocks, E) float32
template <typename T>
int det_shape_t(long long N, int D_in, int W, int n_hidden, int D_out, long long* out) {
  mm::BwdLayout lay;
  switch (W) {
    case 16: lay = mm::bwd_layout<T, 16>(D_in, n_hidden, D_out); break;
    case 32: lay = mm::bwd_layout<T, 32>(D_in, n_hidden, D_out); break;
    case 64: lay = mm::bwd_layout<T, 64>(D_in, n_hidden, D_out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  size_t smem = 0;
  const int warps = mm::bwd_pick_warps((size_t)lay.words * 4, lay.warp_bytes, &smem);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  out[0] = det_blocks(N, warps);
  out[1] = lay.dw_tiles * 128;
  return 0;
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
// shapes as the weights, zeroed by the caller); D_out <= 8; x and g start
// 16-byte aligned; 0 <= part[b] < P is checked on the host. Returns
// cudaErrorInvalidValue for shapes the kernel does not take (the weights'
// fragments and one warp's region above 227 KB: bwd_layout).
extern "C" int repro_fused_mlp_bwd(const void* x, const void* w_in,
                                   const void* w_hid, const void* w_out,
                                   const void* g, const void* part, void* dx,
                                   void* dw_in, void* dw_hid, void* dw_out,
                                   long long B, long long N, int D_in, int W,
                                   int n_hidden, int n_hid_slab, int D_out,
                                   int is_bf16, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535 || n_hidden < 1 || D_out < 1 || D_out > 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(part);
  float* di = static_cast<float*>(dw_in);
  float* dh = static_cast<float*>(dw_hid);
  float* dout = static_cast<float*>(dw_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch_bwd<__nv_bfloat16>(x, w_in, w_hid, w_out, g, p, dx, di, dh, dout, B, N, D_in, W, n_hidden, n_hid_slab, D_out, s)
      : launch_bwd<float>(x, w_in, w_hid, w_out, g, p, dx, di, dh, dout, B, N, D_in, W, n_hidden, n_hid_slab, D_out, s));
}

// The deterministic route of repro_fused_mlp_bwd: the same operands and
// outputs (dw_in / dw_hid / dw_out zeroed by the caller, each weight
// written once), P partitions, and partials, a float32 scratch of (B,
// blocks, E) from repro_fused_mlp_bwd_det_shape. Two launches: the
// backward on det_blocks(N) blocks a batch row, then the ordered sum.
extern "C" int repro_fused_mlp_bwd_det(const void* x, const void* w_in,
                                       const void* w_hid, const void* w_out,
                                       const void* g, const void* part, void* dx,
                                       void* dw_in, void* dw_hid, void* dw_out,
                                       void* partials, long long B, long long N,
                                       long long P, int D_in, int W, int n_hidden,
                                       int n_hid_slab, int D_out, int is_bf16,
                                       void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (B > 65535 || n_hidden < 1 || D_out < 1 || D_out > 8 || partials == nullptr ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(part);
  float* di = static_cast<float*>(dw_in);
  float* dh = static_cast<float*>(dw_hid);
  float* dout = static_cast<float*>(dw_out);
  float* pr = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch_bwd<__nv_bfloat16>(x, w_in, w_hid, w_out, g, p, dx, di, dh, dout, B, N, D_in, W, n_hidden, n_hid_slab, D_out, s, pr, P)
      : launch_bwd<float>(x, w_in, w_hid, w_out, g, p, dx, di, dh, dout, B, N, D_in, W, n_hidden, n_hid_slab, D_out, s, pr, P));
}

// out (2 int64, host memory) = (blocks a batch row, floats a block's row)
// of repro_fused_mlp_bwd_det's partials at these shapes
extern "C" int repro_fused_mlp_bwd_det_shape(long long N, int D_in, int W,
                                             int n_hidden, int D_out, int is_bf16,
                                             void* out) {
  long long* o = static_cast<long long*>(out);
  return is_bf16 ? det_shape_t<__nv_bfloat16>(N, D_in, W, n_hidden, D_out, o)
                 : det_shape_t<float>(N, D_in, W, n_hidden, D_out, o);
}

// repro_fused_mlp_bwd at W = 16 with a clock on each warp: the same outputs,
// and the warps' cycles by stage (mlp_mma.cuh BwdStage: waiting for a
// tile's rows, recompute, delta chain, dW, dx products, dx out, the block's
// dW sum) added to clocks[0 .. 7), their lifetimes in ns to clocks[7]
// (zeroed by the caller). A measurement of where the kernel's time goes;
// the marks cost a few cycles each.
extern "C" int repro_fused_mlp_bwd_stages(const void* x, const void* w_in,
                                          const void* w_hid, const void* w_out,
                                          const void* g, const void* part, void* dx,
                                          void* dw_in, void* dw_hid, void* dw_out,
                                          long long B, long long N, int D_in, int W,
                                          int n_hidden, int n_hid_slab, int D_out,
                                          int is_bf16, void* clocks, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (W != 16 || B > 65535 || n_hidden < 1 || D_out < 1 || D_out > 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(part);
  float* di = static_cast<float*>(dw_in);
  float* dh = static_cast<float*>(dw_hid);
  float* dout = static_cast<float*>(dw_out);
  unsigned long long* c = static_cast<unsigned long long*>(clocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
      ? launch_bwd_w<__nv_bfloat16, 16, mm::StageClock>(x, w_in, w_hid, w_out, g, p, dx, di, dh, dout, B, N, D_in, n_hidden, n_hid_slab, D_out, s, c)
      : launch_bwd_w<float, 16, mm::StageClock>(x, w_in, w_hid, w_out, g, p, dx, di, dh, dout, B, N, D_in, n_hidden, n_hid_slab, D_out, s, c));
}

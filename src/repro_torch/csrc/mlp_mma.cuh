// The bias-free ReLU MLP of a warp's tile of rows on Hopper's tensor cores:
// the forward is the shared core of the MLP forward kernel (fused_mlp.cu)
// and the INR inference kernel (inr_forward.cu); the pieces of the MLP
// backward kernel (fused_mlp.cu) follow it, from "The backward" below.
//
// A warp runs 16 x MT rows at a time through every layer with mma.sync:
//   - bfloat16 operands: m16n8k16.bf16, products summed in float32;
//   - float32 operands: m16n8k8.tf32 three times per product (3xTF32: each
//     operand split into a tf32 head and a tf32 tail, a_hi b_hi + a_hi b_lo
//     + a_lo b_hi with the small terms first, float32 sums), which keeps
//     about 22 bits of each operand where one tf32 product keeps 11.
// The weights sit in shared memory, loaded once per block already laid out
// as B fragments: a lane reads its part of a fragment with one 8-byte
// (bf16) or 16-byte (tf32 head and tail) load, and the 32 lanes of a warp
// read 256 or 512 consecutive bytes.
//
// Between layers nothing goes through shared memory. Each layer's float32
// accumulator fragment takes its ReLU (max(h, 0) with NaN passed through,
// like jnp.maximum) and, under bf16, its rounding to bfloat16, and is
// re-packed in registers as the next layer's A fragment (the design of
// tiny-cuda-nn's fully fused MLP, Mueller et al.). For m16n8k16 the C
// fragment of n-tiles 2k and 2k+1 is exactly the A fragment of k-tile k.
// For m16n8k8 the C fragment holds columns (2t, 2t+1) of a lane's rows
// where the A fragment wants (t, t+4); instead of shuffling, the k order
// inside each k-tile is permuted: mma column t stands for k = 2t, column
// t+4 for k = 2t+1, and the B fragments are packed in the same order.
//
// The first layer's A fragments come from the caller's tile of input rows
// in shared memory (row stride `stride`, see tile_stride). Its columns at
// and past D_in are read as zero: K = D_in is padded to the mma's k (16 or
// 8) in registers, and the output width D_out (at most 8) to n = 8 in the
// fragments. W is 16, 32 or 64; H (the hidden layers) any count whose
// fragments fit the block's shared memory.
//
// Numerics, as the plain version (fused_mlp/ref.py): float32 sums; under
// bf16 each hidden layer's ReLU output is rounded to bfloat16 before the
// next layer; the output is left in float32 for the caller to round.
// Tensor cores sum in their own order (and round the float32 sums of a
// product group their own way), so the last bits differ from a loop of
// FMAs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace mma {

// rows of input one warp stages at a time (two m16 tiles)
constexpr int TILE_ROWS = 32;

// The row stride (in elements) of an input tile in shared memory: at least
// D_in, and 8 mod 16, which makes the first layer's fragment loads free of
// bank conflicts (8-byte float pairs or 4-byte bf16 pairs, rows g = 0..7 of
// a fragment land on distinct banks) and keeps every row 16-byte aligned.
__host__ __device__ __forceinline__ int tile_stride(int D_in) {
  return (D_in + 7) / 16 * 16 + 8;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the operand type's fragments and product
template <typename T> struct Ops;

template <> struct Ops<__nv_bfloat16> {
  static constexpr int KSTEP = 16;   // k of one mma
  static constexpr int LW = 2;       // 32-bit words of a B fragment per lane
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ B load_b(const uint32_t* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return {{v.x, v.y}};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  // word j (0, 1) of lane (g, t)'s part of B fragment (kt, n): rows
  // k0 = 16 kt + 2t + 8j and k0 + 1, the lower k in the low half
  static __device__ __forceinline__ uint32_t pack_b(const __nv_bfloat16* src, int K,
                                                    int N, int kt, int t, int n,
                                                    int j) {
    const int k0 = kt * 16 + 2 * t + 8 * j;
    unsigned short lo = 0, hi = 0;
    if (n < N && k0 < K) lo = __bfloat16_as_ushort(src[(size_t)k0 * N + n]);
    if (n < N && k0 + 1 < K) hi = __bfloat16_as_ushort(src[(size_t)(k0 + 1) * N + n]);
    return (uint32_t)lo | ((uint32_t)hi << 16);
  }
  // k-tile kt of the first layer from the input tile (rows g and g+8 of
  // `rows`, columns 16 kt + 2t (+1) and +8): one 4-byte load per pair; a
  // pair at or past D_in is zero (its odd partner, where D_in is odd, is
  // the tile's zeroed padding)
  static __device__ __forceinline__ A load_a(const __nv_bfloat16* rows, int stride,
                                             int kt, int D_in, int g, int t) {
    const int c0 = kt * 16 + 2 * t, c1 = c0 + 8;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(rows + g * stride);
    const uint32_t* r8 = reinterpret_cast<const uint32_t*>(rows + (g + 8) * stride);
    A a;
    a.r[0] = c0 < D_in ? r0[c0 >> 1] : 0u;
    a.r[1] = c0 < D_in ? r8[c0 >> 1] : 0u;
    a.r[2] = c1 < D_in ? r0[c1 >> 1] : 0u;
    a.r[3] = c1 < D_in ? r8[c1 >> 1] : 0u;
    return a;
  }
  // k-tile kt of a hidden layer's input: the ReLU of n-tiles 2kt, 2kt+1 of
  // the layer below, rounded to bfloat16
  template <int NT>
  static __device__ __forceinline__ A from_acc(const float (&c)[NT][4], int kt) {
    A a;
    a.r[0] = pack(relu(c[2 * kt][0]), relu(c[2 * kt][1]));
    a.r[1] = pack(relu(c[2 * kt][2]), relu(c[2 * kt][3]));
    a.r[2] = pack(relu(c[2 * kt + 1][0]), relu(c[2 * kt + 1][1]));
    a.r[3] = pack(relu(c[2 * kt + 1][2]), relu(c[2 * kt + 1][3]));
    return a;
  }
};

template <> struct Ops<float> {
  static constexpr int KSTEP = 8;
  static constexpr int LW = 4;       // head (k = 2t, 2t+1), then tail
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t r[4]; };

  static __device__ __forceinline__ B load_b(const uint32_t* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    return {{v.x, v.y, v.z, v.w}};
  }
  static __device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // 3xTF32, the two small terms first
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma1(c, a.lo, b.r[0], b.r[1]);
    mma1(c, a.hi, b.r[2], b.r[3]);
    mma1(c, a.hi, b.r[0], b.r[1]);
  }
  static __device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(v);
    lo = tf32_rna(v - __uint_as_float(hi));
  }
  // word j (0..3) of lane (g, t)'s part of B fragment (kt, n): the head of
  // rows k = 8 kt + 2t and 8 kt + 2t + 1 (mma rows t and t+4), then their
  // tails
  static __device__ __forceinline__ uint32_t pack_b(const float* src, int K, int N,
                                                    int kt, int t, int n, int j) {
    const int k = kt * 8 + 2 * t + (j & 1);
    const float v = (n < N && k < K) ? src[(size_t)k * N + n] : 0.0f;
    uint32_t hi, lo;
    split(v, hi, lo);
    return j < 2 ? hi : lo;
  }
  // k-tile kt of the first layer: columns 8 kt + 2t, +1 of rows g and g+8,
  // one 8-byte load each (mma columns t and t+4)
  static __device__ __forceinline__ A load_a(const float* rows, int stride, int kt,
                                             int D_in, int g, int t) {
    const int c = kt * 8 + 2 * t;
    const float2 z = make_float2(0.0f, 0.0f);
    const float2 v0 = c < D_in ? *reinterpret_cast<const float2*>(rows + g * stride + c) : z;
    const float2 v8 = c < D_in ? *reinterpret_cast<const float2*>(rows + (g + 8) * stride + c) : z;
    A a;
    split(v0.x, a.hi[0], a.lo[0]);
    split(v8.x, a.hi[1], a.lo[1]);
    split(v0.y, a.hi[2], a.lo[2]);
    split(v8.y, a.hi[3], a.lo[3]);
    return a;
  }
  // k-tile kt of a hidden layer's input: the ReLU of n-tile kt below
  template <int NT>
  static __device__ __forceinline__ A from_acc(const float (&c)[NT][4], int kt) {
    A a;
    split(relu(c[kt][0]), a.hi[0], a.lo[0]);
    split(relu(c[kt][2]), a.hi[1], a.lo[1]);
    split(relu(c[kt][1]), a.hi[2], a.lo[2]);
    split(relu(c[kt][3]), a.hi[3], a.lo[3]);
    return a;
  }
};

// The MLP's shape as the kernels see it
struct Shape {
  int D_in, H, D_out;   // W is a template parameter
};

// 32-bit words of shared memory the weight fragments take
template <typename T>
__host__ __device__ __forceinline__ int weight_words(int D_in, int W, int H) {
  constexpr int KS = Ops<T>::KSTEP, LW = Ops<T>::LW;
  const int kt0 = (D_in + KS - 1) / KS;
  return 32 * LW * (kt0 * (W / 8) + (H - 1) * (W / KS) * (W / 8) + W / KS);
}

// Block-cooperative: the partition's weights (w_in (D_in, W), the H-1
// hidden (W, W) layers one after another, w_out (W, D_out)) into `sw` as
// B fragments, layer after layer, each layer's fragments in (kt, nt) order.
// The caller synchronises the block before use.
template <typename T, int W>
__device__ __forceinline__ void load_weights(uint32_t* sw, const T* w_in,
                                             const T* w_hid, const T* w_out,
                                             const Shape& s) {
  constexpr int KS = Ops<T>::KSTEP, LW = Ops<T>::LW;
  int base = 0;
  for (int layer = 0; layer <= s.H; ++layer) {
    const bool first = layer == 0, last = layer == s.H;
    const int K = first ? s.D_in : W, N = last ? s.D_out : W;
    const int kts = first ? (s.D_in + KS - 1) / KS : W / KS;
    const int nts = last ? 1 : W / 8;
    const T* src = first ? w_in : last ? w_out : w_hid + (size_t)(layer - 1) * W * W;
    const int words = kts * nts * 32 * LW;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int j = i % LW, lane = (i / LW) % 32, frag = i / (LW * 32);
      const int kt = frag / nts, nt = frag - kt * nts;
      sw[base + i] = Ops<T>::pack_b(src, K, N, kt, lane & 3, nt * 8 + (lane >> 2), j);
    }
    base += words;
  }
}

// The forward of MT m16 tiles of rows (rows[0 .. 16 MT) of the input tile,
// row stride `stride`) through every layer: out[m] is the output layer's C
// fragment of m-tile m (rows 16m + g and 16m + g + 8, columns 2t and 2t+1,
// float32, not yet rounded). Every lane of the warp calls it.
template <typename T, int W, int MT>
__device__ __forceinline__ void forward(const uint32_t* sw, const T* rows, int stride,
                                        const Shape& s, float (&out)[MT][4]) {
  using O = Ops<T>;
  constexpr int KS = O::KSTEP, LW = O::LW, NT = W / 8, KTW = W / KS;
  constexpr int FRAG = 32 * LW;   // words of one fragment
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* wl = sw + lane * LW;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0f;
  const int kt0 = (s.D_in + KS - 1) / KS;
  for (int kt = 0; kt < kt0; ++kt) {
    typename O::A a[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) a[m] = O::load_a(rows + m * 16 * stride, stride, kt, s.D_in, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const typename O::B b = O::load_b(wl + (kt * NT + n) * FRAG);
#pragma unroll
      for (int m = 0; m < MT; ++m) O::mma(acc[m][n], a[m], b);
    }
  }
  wl += kt0 * NT * FRAG;
  for (int h = 1; h < s.H; ++h) {
    float nxt[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) nxt[m][n][i] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KTW; ++kt) {
      typename O::A a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) a[m] = O::template from_acc<NT>(acc[m], kt);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const typename O::B b = O::load_b(wl + (kt * NT + n) * FRAG);
#pragma unroll
        for (int m = 0; m < MT; ++m) O::mma(nxt[m][n], a[m], b);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = nxt[m][n][i];
    wl += KTW * NT * FRAG;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[m][i] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KTW; ++kt) {
    const typename O::B b = O::load_b(wl + kt * FRAG);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const typename O::A a = O::template from_acc<NT>(acc[m], kt);
      O::mma(out[m], a, b);
    }
  }
}

// A warp's TILE_ROWS rows of the input tile through the MLP, MT m-tiles
// at a time (two read each weight fragment once for both; one takes half
// the registers), each valid output written to out_rows (row r at
// out_rows + r * D_out, rounded to T): rows at and past n_valid are
// computed and dropped.
template <typename T, int W, int MT>
__device__ __forceinline__ void tile_forward(const uint32_t* sw, const T* tile,
                                             int stride, const Shape& s,
                                             T* out_rows, int n_valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int pass = 0; pass < TILE_ROWS / (16 * MT); ++pass) {
    float o[MT][4];
    forward<T, W, MT>(sw, tile + pass * 16 * MT * stride, stride, s, o);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = (pass * MT + m) * 16 + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r + (i >> 1) * 8, col = c + (i & 1);
        if (row < n_valid && col < s.D_out)
          out_rows[(size_t)row * s.D_out + col] = from_f32<T>(o[m][i]);
      }
    }
  }
}

// Warps per block and dynamic shared memory: the largest of 8, 4, 2, 1
// warps whose `fixed` bytes plus `per_warp` bytes each fit the 227 KB a
// block may use; 0 when not even one fits.
inline int pick_warps(size_t fixed, size_t per_warp, size_t* smem) {
  for (int w = 8; w >= 1; w >>= 1) {
    const size_t bytes = fixed + (size_t)w * per_warp;
    if (bytes <= 232448) {
      *smem = bytes;
      return w;
    }
  }
  return 0;
}

// Blocks per batch row: enough for every SM to hold as many blocks as the
// kernel's occupancy allows, and no more than the row's tiles need (each
// block then walks its row's tiles with a grid stride, its weights loaded
// once). Where `one_wave`, the SMs' blocks are split over the batch rows
// rounding down, so that every block starts at once: a block beyond what
// the SMs hold waits for a first one to finish, and its grid-stride share
// of tiles then ends a whole block's time after the rest.
inline long long grid_x(const void* kernel, int threads, size_t smem,
                        long long n_tiles, int warps, long long rows,
                        bool one_wave = false) {
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long slots = (long long)sms * per_sm;
  const long long want = !one_wave ? (slots + rows - 1) / rows
                         : slots >= rows ? slots / rows : 1;
  const long long need = (n_tiles + warps - 1) / warps;
  return want < need ? want : need;
}


// ---------------------------------------------------------------- backward
//
// The backward: a warp's pass of RP rows (bwd_pass) through
//   - the recompute: the forward above, each hidden layer's ReLU output
//     (rounded to the operand type) kept in a row-major tile in shared
//     memory;
//   - the delta chain, delta_{H-1} = (g W_out^T) * mask_{H-1} and
//     delta_{l-1} = (delta_l W_l^T) * mask_{l-1}, and dx = delta_0 W_in^T:
//     row-local products of the forward's fragment shapes, with the
//     transposed weights packed as B fragments next to the forward ones.
//     Each delta is rounded to the operand type (under bf16 the plain
//     version's rounding before the mask), masked by the stored activations
//     (a unit passes where its output is > 0) and stored in a row-major
//     tile, from which the next product reads its A fragments as the
//     forward reads its input tile;
//   - dW_l = act_{l-1}^T delta_l (x for l = 0; g for the output layer),
//     the rows as the mma's k: A = act^T and B = delta are read from the
//     row-major tiles transposed, with ldmatrix.trans under bf16 and
//     strided shared loads under float32 (each value split into its tf32
//     head and tail there). Each dW tile's sum over the pass is added to
//     the warp's float32 dW in shared memory, kept as C fragments: one
//     16-byte read and write a lane per tile and pass.
// The activation and delta tiles have a row stride of W + 8 elements: an
// odd multiple of 16 bytes under bf16 (ldmatrix's 8 rows on distinct
// banks) and 8 mod 32 words under float32 (the strided loads' 4 rows x 8
// columns on distinct banks).

// float32 operands whose B fragments are stored unsplit (two words a lane:
// rows k = 8 kt + 2t and +1, mma rows t and t+4) and split into tf32 head
// and tail where they are loaded: half the shared memory of Ops<float>'s,
// for W = 64, where both orientations of the pre-split weights would not fit
// a block
struct OpsLean : Ops<float> {
  static constexpr int LW = 2;
  static __device__ __forceinline__ B load_b(const uint32_t* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    B b;
    split(__uint_as_float(v.x), b.r[0], b.r[2]);
    split(__uint_as_float(v.y), b.r[1], b.r[3]);
    return b;
  }
};

// The backward's configuration for operands T at width W: the fragments'
// type, the rows of a pass (RP: one m-tile; 32-row passes, two m-tiles side
// by side, measured slower on the H100: their tiles cut the warps an SM
// holds from 12 to 8 under float32) and the activation and delta tiles' row
// stride
template <typename T, int W> struct Bwd {
  using O = std::conditional_t<sizeof(T) == 2, Ops<__nv_bfloat16>,
                               std::conditional_t<W == 64, OpsLean, Ops<float>>>;
  static constexpr int RP = 16;
  static constexpr int KS = O::KSTEP, LW = O::LW, FRAG = 32 * LW;
  static constexpr int NT = W / 8, KTW = W / KS, MW = W / 16;
  static constexpr int AS = W + 8;
};

// The cotangent tile's row stride: 8 (ldmatrix rows of 16 bytes under
// bf16), or 2 for float32 cotangents of at most 2 columns
template <typename T>
__host__ __device__ __forceinline__ int bwd_g_stride(int D_out) {
  return sizeof(T) == 4 && D_out <= 2 ? 2 : 8;
}

// Where the backward's pieces lie in a block's shared memory: first the
// weights' fragments (32-bit words), the forward's (w_in, the hidden layers;
// the output layer is not recomputed) and then the transposed ones (w_out^T
// as K = D_out, the hidden layers', w_in^T with N = D_in); then one region a
// warp: its dW (dw_tiles C fragments of 32 x 4 floats: dW_in's mi x NT, each
// hidden layer's MW x NT, dW_out's MW), two x tiles and two g tiles of
// TILE_ROWS rows, the H activation tiles and two delta tiles of RP rows.
struct BwdLayout {
  int kt0, nx, mi;            // k-tiles of w_in, n-tiles of dx, m-tiles of dW_in
  int t_out, t_hid, t_in;     // word offsets of the transposed fragments
  int words;                  // every fragment
  int dw_tiles, xs, gs, warp_bytes;
};

template <typename T, int W>
__host__ __device__ __forceinline__ BwdLayout bwd_layout(int D_in, int H, int D_out) {
  using C = Bwd<T, W>;
  BwdLayout l;
  l.kt0 = (D_in + C::KS - 1) / C::KS;
  l.nx = (D_in + 7) / 8;
  l.mi = (D_in + 15) / 16;
  const int f_hid = (H - 1) * C::KTW * C::NT;
  l.t_out = (l.kt0 * C::NT + f_hid) * C::FRAG;
  l.t_hid = l.t_out + C::NT * C::FRAG;
  l.t_in = l.t_hid + f_hid * C::FRAG;
  l.words = l.t_in + C::KTW * l.nx * C::FRAG;
  l.dw_tiles = l.mi * C::NT + (H - 1) * C::MW * C::NT + C::MW;
  l.xs = tile_stride(D_in);
  l.gs = bwd_g_stride<T>(D_out);
  l.warp_bytes = l.dw_tiles * 512 +
                 (int)sizeof(T) * (2 * TILE_ROWS * (l.xs + l.gs) + (H + 2) * C::RP * C::AS);
  return l;
}

// Warps per block and dynamic shared memory for the backward: of 8, 4, 2
// and 1 warps within the 227 KB a block may use, the count that keeps the
// most warps resident on an SM (228 KB, 1 KB reserved a block; the larger
// block on a tie); 0 when not even one fits
inline int bwd_pick_warps(size_t fixed, size_t per_warp, size_t* smem) {
  int best = 0, best_resident = 0;
  for (int w = 8; w >= 1; w >>= 1) {
    const size_t bytes = fixed + (size_t)w * per_warp;
    if (bytes > 232448) continue;
    const int resident = (int)(233472 / (bytes + 1024)) * w;
    if (resident > best_resident) {
      best = w;
      best_resident = resident;
      *smem = bytes;
    }
  }
  return best;
}

// word j of lane (g, t)'s part of B fragment (kt, n) in O's layout, of the
// K x N matrix whose element (k, n) is src[k sk + n sn]: (sk, sn) = (N, 1)
// packs a row-major weight matrix as Ops<T>::pack_b does, (1, K) the
// transpose of a row-major N x K one
template <typename O, typename T>
__device__ __forceinline__ uint32_t pack_bs(const T* src, size_t sk, size_t sn, int K,
                                            int N, int kt, int t, int n, int j) {
  if constexpr (sizeof(T) == 2) {
    const int k0 = kt * 16 + 2 * t + 8 * j;
    unsigned short lo = 0, hi = 0;
    if (n < N && k0 < K) lo = __bfloat16_as_ushort(src[k0 * sk + n * sn]);
    if (n < N && k0 + 1 < K) hi = __bfloat16_as_ushort(src[(k0 + 1) * sk + n * sn]);
    return (uint32_t)lo | ((uint32_t)hi << 16);
  } else {
    const int k = kt * 8 + 2 * t + (j & 1);
    const float v = (n < N && k < K) ? src[k * sk + n * sn] : 0.0f;
    if constexpr (O::LW == 2) {
      return __float_as_uint(v);   // OpsLean: split where it is loaded
    } else {
      uint32_t hi, lo;
      Ops<float>::split(v, hi, lo);
      return j < 2 ? hi : lo;
    }
  }
}

// Block-cooperative: kts x nts fragments of that matrix into dst, in
// (kt, nt) order
template <typename O, typename T>
__device__ __forceinline__ void pack_frags(uint32_t* dst, const T* src, size_t sk,
                                           size_t sn, int K, int N, int kts, int nts) {
  constexpr int LW = O::LW;
  const int words = kts * nts * 32 * LW;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int j = i % LW, lane = (i / LW) % 32, frag = i / (LW * 32);
    const int kt = frag / nts, nt = frag - kt * nts;
    dst[i] = pack_bs<O>(src, sk, sn, K, N, kt, lane & 3, nt * 8 + (lane >> 2), j);
  }
}

// Block-cooperative: the partition's weights as the backward's fragments
// (bwd_layout). The caller synchronises the block before use.
template <typename T, int W>
__device__ __forceinline__ void load_weights_bwd(uint32_t* sw, const BwdLayout& lay,
                                                 const T* w_in, const T* w_hid,
                                                 const T* w_out, const Shape& s) {
  using C = Bwd<T, W>;
  using O = typename C::O;
  constexpr int HF = C::KTW * C::NT * C::FRAG;   // words of one hidden layer
  pack_frags<O>(sw, w_in, W, 1, s.D_in, W, lay.kt0, C::NT);
  pack_frags<O>(sw + lay.t_out, w_out, 1, s.D_out, s.D_out, W, 1, C::NT);
  for (int h = 1; h < s.H; ++h) {
    const T* wh = w_hid + (size_t)(h - 1) * W * W;
    pack_frags<O>(sw + lay.kt0 * C::NT * C::FRAG + (h - 1) * HF, wh, W, 1, W, W,
                  C::KTW, C::NT);
    pack_frags<O>(sw + lay.t_hid + (h - 1) * HF, wh, 1, W, W, W, C::KTW, C::NT);
  }
  pack_frags<O>(sw + lay.t_in, w_in, 1, W, W, s.D_in, C::KTW, lay.nx);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two adjacent values of a row-major tile, stored in T (rounded) or read
template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint32_t*>(p) = Ops<__nv_bfloat16>::pack(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}
template <typename T> __device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  } else {
    return *reinterpret_cast<const float2*>(p);
  }
}

// C fragments (rows g and g + 8, columns 8n + 2t and +1) into the row-major
// tile dst: their ReLU, rounded to T
template <typename T, int NT>
__device__ __forceinline__ void store_act(const float (&c)[NT][4], T* dst, int stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    store2(dst + g * stride + 8 * n + 2 * t, relu(c[n][0]), relu(c[n][1]));
    store2(dst + (g + 8) * stride + 8 * n + 2 * t, relu(c[n][2]), relu(c[n][3]));
  }
}

// C fragments of a delta before its mask into the row-major tile dst:
// rounded to T, zero where the layer's stored output `act` is not > 0
template <typename T, int NT>
__device__ __forceinline__ void store_delta(const float (&c)[NT][4], const T* act, T* dst,
                                            int stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = (g + 8 * h) * stride + 8 * n + 2 * t;
      const float2 a = load2(act + off);
      store2(dst + off, a.x > 0.0f ? c[n][2 * h] : 0.0f, a.y > 0.0f ? c[n][2 * h + 1] : 0.0f);
    }
  }
}

// The dW products' fragments, the rows of a row-major tile as the mma's k:
// at_frag is the A fragment of (src^T)[c0 .., r0 ..] (16 columns as m, KS
// rows as k), bt_frag the B fragment of src[r0 .., c0 ..] (KS rows as k,
// 8 columns as n). Columns at and past `cols` read as zero.
__device__ __forceinline__ Ops<__nv_bfloat16>::A at_frag(const __nv_bfloat16* src,
                                                         int stride, int r0, int c0,
                                                         int cols) {
  // matrix j = lane / 8 of ldmatrix.x4: rows r0 + 8 (j >> 1) .., columns
  // c0 + 8 (j & 1) ..; transposed, it is A register j
  const int lane = threadIdx.x & 31, j = lane >> 3;
  const int c = c0 + 8 * (j & 1);
  const __nv_bfloat16* p = src + (r0 + 8 * (j >> 1) + (lane & 7)) * stride + (c < cols ? c : 0);
  Ops<__nv_bfloat16>::A a;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
               : "r"(smem_addr(p))
               : "memory");
  if (c0 >= cols) a.r[0] = a.r[2] = 0u;
  if (c0 + 8 >= cols) a.r[1] = a.r[3] = 0u;
  return a;
}
__device__ __forceinline__ Ops<__nv_bfloat16>::B bt_frag(const __nv_bfloat16* src,
                                                         int stride, int r0, int c0, int) {
  // a tile's columns past its valid ones are its zeroed padding
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = src + (r0 + (lane & 15)) * stride + c0;
  Ops<__nv_bfloat16>::B b;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b.r[0]), "=r"(b.r[1])
               : "r"(smem_addr(p))
               : "memory");
  return b;
}
__device__ __forceinline__ Ops<float>::A at_frag(const float* src, int stride, int r0,
                                                 int c0, int cols) {
  const int lane = threadIdx.x & 31, u = c0 + (lane >> 2), u8 = u + 8;
  const float* p0 = src + (r0 + (lane & 3)) * stride;
  const float* p4 = p0 + 4 * stride;
  Ops<float>::A a;
  Ops<float>::split(u < cols ? p0[u] : 0.0f, a.hi[0], a.lo[0]);
  Ops<float>::split(u8 < cols ? p0[u8] : 0.0f, a.hi[1], a.lo[1]);
  Ops<float>::split(u < cols ? p4[u] : 0.0f, a.hi[2], a.lo[2]);
  Ops<float>::split(u8 < cols ? p4[u8] : 0.0f, a.hi[3], a.lo[3]);
  return a;
}
__device__ __forceinline__ Ops<float>::B bt_frag(const float* src, int stride, int r0,
                                                 int c0, int cols) {
  const int lane = threadIdx.x & 31, n = c0 + (lane >> 2);
  const float* p = src + (r0 + (lane & 3)) * stride + n;
  Ops<float>::B b;
  Ops<float>::split(n < cols ? p[0] : 0.0f, b.r[0], b.r[2]);
  Ops<float>::split(n < cols ? p[4 * stride] : 0.0f, b.r[1], b.r[3]);
  return b;
}

// The backward's accumulators: under float32 the sum of the head products
// (a_hi b_hi) and the sum of 3xTF32's two small terms kept apart, so that a
// product's three mma form two dependent chains instead of one; the value
// is their sum
template <typename T> struct Acc {
  float c[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = 0.0f;
  }
  __device__ __forceinline__ float operator[](int i) const { return c[i]; }
};
template <> struct Acc<float> {
  float c[4], e[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = e[i] = 0.0f;
  }
  __device__ __forceinline__ float operator[](int i) const { return c[i] + e[i]; }
};

__device__ __forceinline__ void mma_acc(Acc<__nv_bfloat16>& acc,
                                        const Ops<__nv_bfloat16>::A& a,
                                        const Ops<__nv_bfloat16>::B& b) {
  Ops<__nv_bfloat16>::mma(acc.c, a, b);
}
__device__ __forceinline__ void mma_acc(Acc<float>& acc, const Ops<float>::A& a,
                                        const Ops<float>::B& b) {
  Ops<float>::mma1(acc.e, a.lo, b.r[0], b.r[1]);
  Ops<float>::mma1(acc.e, a.hi, b.r[2], b.r[3]);
  Ops<float>::mma1(acc.c, a.hi, b.r[0], b.r[1]);
}

template <typename T, int N>
__device__ __forceinline__ void acc_values(const Acc<T> (&acc)[N], float (&v)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[n][i] = acc[n][i];
}

// dw (mtiles x NI C fragments, (mt, nt) order) += a^T b over RP rows: a
// (RP x a_cols, row stride as) and b (RP x b_cols, stride bs) row-major.
// b's fragments are loaded once; the NI tiles of an m-tile are summed side
// by side.
template <typename T, int RP, int NI>
__device__ __forceinline__ void dw_accum(float* dw, const T* a, int as, int a_cols,
                                         int mtiles, const T* b, int bs, int b_cols) {
  constexpr int KS = Ops<T>::KSTEP, KSTEPS = RP / KS;
  const int lane = threadIdx.x & 31;
  typename Ops<T>::B bf[KSTEPS][NI];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) bf[ks][nt] = bt_frag(b, bs, ks * KS, nt * 8, b_cols);
#pragma unroll 1
  for (int mt = 0; mt < mtiles; ++mt) {
    Acc<T> acc[NI];
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) acc[nt].zero();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const typename Ops<T>::A af = at_frag(a, as, ks * KS, mt * 16, a_cols);
#pragma unroll
      for (int nt = 0; nt < NI; ++nt) mma_acc(acc[nt], af, bf[ks][nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
      float4* d = reinterpret_cast<float4*>(dw) + (mt * NI + nt) * 32 + lane;
      float4 v = *d;
      v.x += acc[nt][0];
      v.y += acc[nt][1];
      v.z += acc[nt][2];
      v.w += acc[nt][3];
      *d = v;
    }
  }
}

// The forward of a pass's rows (one m-tile of the input tile at `rows`, row
// stride `stride`) through the hidden layers, layer l's ReLU output
// (rounded to T) stored at act + l * lstride (row stride AS). The output
// layer is not needed.
template <typename T, int W>
__device__ __forceinline__ void recompute(const uint32_t* sw, const T* rows, int stride,
                                          const Shape& s, T* act, int lstride) {
  using C = Bwd<T, W>;
  using O = typename C::O;
  constexpr int NT = C::NT, KTW = C::KTW, FRAG = C::FRAG, KS = C::KS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* wl = sw + lane * C::LW;
  Acc<T> acc[NT];
  float v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n].zero();
  const int kt0 = (s.D_in + KS - 1) / KS;
  for (int kt = 0; kt < kt0; ++kt) {
    const typename O::A a = O::load_a(rows, stride, kt, s.D_in, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_acc(acc[n], a, O::load_b(wl + (kt * NT + n) * FRAG));
  }
  acc_values(acc, v);
  store_act<T, NT>(v, act, C::AS);
  wl += kt0 * NT * FRAG;
  for (int h = 1; h < s.H; ++h) {
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n].zero();
#pragma unroll
    for (int kt = 0; kt < KTW; ++kt) {
      const typename O::A a = O::template from_acc<NT>(v, kt);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_acc(acc[n], a, O::load_b(wl + (kt * NT + n) * FRAG));
    }
    acc_values(acc, v);
    store_act<T, NT>(v, act + h * lstride, C::AS);
    wl += KTW * NT * FRAG;
  }
}

// One delta of a pass: (the row-major tile a, row stride as, K = kts
// k-tiles, columns at and past k_cols zero) x the fragments at wl ((kt, n)
// order, NT n-tiles a k-tile), rounded to T, masked by the layer's stored
// outputs `act` and stored in the delta tile dst (both of row stride AS)
template <typename T, int W>
__device__ __forceinline__ void delta_product(const T* a, int as, int kts, int k_cols,
                                              const uint32_t* wl, const T* act, T* dst) {
  using C = Bwd<T, W>;
  using O = typename C::O;
  constexpr int NT = C::NT, FRAG = C::FRAG;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Acc<T> acc[NT];
  float v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n].zero();
#pragma unroll
  for (int kt = 0; kt < kts; ++kt) {
    const typename O::A af = O::load_a(a, as, kt, k_cols, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_acc(acc[n], af, O::load_b(wl + (kt * NT + n) * FRAG));
  }
  acc_values(acc, v);
  store_delta<T, NT>(v, act, dst, C::AS);
}

// Where a warp's time goes in the backward, by stage: waiting for a tile's
// rows (and issuing the next tile's copies), the recompute, the delta
// chain, the dW products, the dx products, dx out, the block's dW sum.
// NoClock (the kernels as they run) records nothing; StageClock adds the
// cycles since its last mark to a stage's count, and its flush adds the
// warp's counts and then its lifetime in ns (the global timer) to a global
// array of kStages + 1 (a measurement: repro_fused_mlp_bwd_stages).
enum BwdStage { kStageWait, kStageRecompute, kStageDelta, kStageDw, kStageDx,
                kStageOut, kStageReduce, kStages };
struct NoClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}
struct StageClock {
  long long last;
  unsigned long long born;
  unsigned t[kStages];
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < kStages; ++i) t[i] = 0;
    born = global_ns();
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
      atomicAdd(out + kStages, global_ns() - born);
    }
  }
};

// One pass of RP rows of a warp's tile through the backward: x rows at xt
// (row stride lay.xs) and their cotangents at gt (row stride lay.gs;
// columns at and past D_out and rows past the batch zero); the weights'
// fragments in sw (bwd_layout); the warp's activation tiles `act` and delta
// tiles `dl`. Adds the pass's dW to the warp's C-fragment tiles dw and
// leaves dx, rounded to T, in the first D_in columns of the x rows; marks
// its stages on clk. Every lane of the warp calls it.
template <typename T, int W, typename Clk>
__device__ __forceinline__ void bwd_pass(const uint32_t* sw, const BwdLayout& lay, T* xt,
                                         const T* gt, T* act, T* dl, float* dw,
                                         const Shape& s, Clk& clk) {
  using C = Bwd<T, W>;
  using O = typename C::O;
  constexpr int NT = C::NT, KTW = C::KTW, FRAG = C::FRAG;
  constexpr int AS = C::AS, MW = C::MW, LA = C::RP * C::AS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* wl = sw + lane * C::LW;
  const int xs = lay.xs, gs = lay.gs, H = s.H;
  float* const dw_hid = dw + lay.mi * NT * 128;   // then dW_out's tiles
  recompute<T, W>(sw, xt, xs, s, act, LA);
  __syncwarp();
  clk.mark(kStageRecompute);
  // delta_{H-1} = (g W_out^T) * mask_{H-1}
  const T* act_top = act + (H - 1) * LA;
  delta_product<T, W>(gt, gs, 1, s.D_out, wl + lay.t_out, act_top, dl);
  __syncwarp();
  clk.mark(kStageDelta);
  dw_accum<T, C::RP, 1>(dw_hid + (H - 1) * MW * NT * 128, act_top, AS, W, MW, gt, gs,
                        s.D_out);
  clk.mark(kStageDw);
  int cur = 0;
  for (int l = H - 1; l >= 1; --l) {
    const T* d = dl + cur * LA;
    dw_accum<T, C::RP, NT>(dw_hid + (l - 1) * MW * NT * 128, act + (l - 1) * LA, AS, W,
                           MW, d, AS, W);
    clk.mark(kStageDw);
    delta_product<T, W>(d, AS, KTW, W, wl + lay.t_hid + (l - 1) * KTW * NT * FRAG,
                        act + (l - 1) * LA, dl + (cur ^ 1) * LA);
    __syncwarp();
    clk.mark(kStageDelta);
    cur ^= 1;
  }
  const T* d0 = dl + cur * LA;
  dw_accum<T, C::RP, NT>(dw, xt, xs, s.D_in, lay.mi, d0, AS, W);
  __syncwarp();   // the x rows are read: dx goes over them
  clk.mark(kStageDw);
  // dx = delta_0 W_in^T, one n-tile (8 columns) at a time
  typename O::A a[KTW];
#pragma unroll
  for (int kt = 0; kt < KTW; ++kt) a[kt] = O::load_a(d0, AS, kt, W, g, t);
  T* r0 = xt + g * xs;
  T* r8 = r0 + 8 * xs;
#pragma unroll 1
  for (int n = 0; n < lay.nx; ++n) {
    Acc<T> acc;
    acc.zero();
#pragma unroll
    for (int kt = 0; kt < KTW; ++kt)
      mma_acc(acc, a[kt], O::load_b(wl + lay.t_in + (kt * lay.nx + n) * FRAG));
    const int col = 8 * n + 2 * t;
    if (col < s.D_in) {
      r0[col] = from_f32<T>(acc[0]);
      r8[col] = from_f32<T>(acc[2]);
    }
    if (col + 1 < s.D_in) {
      r0[col + 1] = from_f32<T>(acc[1]);
      r8[col + 1] = from_f32<T>(acc[3]);
    }
  }
  clk.mark(kStageDx);
}

}  // namespace mma
}  // namespace repro

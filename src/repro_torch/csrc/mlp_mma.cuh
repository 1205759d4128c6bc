// The bias-free ReLU MLP forward of a warp's tile of rows on Hopper's tensor
// cores: the shared core of the MLP forward kernel (fused_mlp.cu) and the
// INR inference kernel (inr_forward.cu).
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
// once).
inline long long grid_x(const void* kernel, int threads, size_t smem,
                        long long n_tiles, int warps, long long rows) {
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long want = ((long long)sms * per_sm + rows - 1) / rows;
  const long long need = (n_tiles + warps - 1) / warps;
  return want < need ? want : need;
}

}  // namespace mma
}  // namespace repro

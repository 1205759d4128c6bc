// Flash attention forward: online-softmax attention with GQA, causal and
// sliding-window masks, right-aligned query positions.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_bhsd
// (the pallas_call at line 112, body _flash_kernel at line 37). The TPU
// kernel walks a (B*Hq, q tiles, k tiles) grid whose k axis runs in order
// and carries the running max, denominator and accumulator across k steps
// in VMEM scratch. A GPU runs blocks in no order, so the k loop moves inside
// the block: one block owns one (batch, q head, q tile), loops over the live
// key tiles staged in shared memory, keeps m, l and the output accumulator
// in float32 registers, and writes its output rows once.
//
// Two kernels, chosen by the input type (explicitly, in repro_flash_attention
// below; no failure routes anything to the other):
//   - bfloat16: the tensor-core kernel (section "bfloat16" below): wgmma for
//     both products, TMA tile copies through a ring of K/V stages, 128-row q
//     tiles, 128-key tiles;
//   - float32: the CUDA-core kernel (next), 64-row q tiles: a TF32 product
//     would break the float32 results' 2e-5 limit.
//
// Layout: q (B,Sq,Hq,dh) and k, v, out (B,Sk,Hkv,dh) / (B,Sq,Hq,dh), the
// model layout, read in place through their row strides (H*dh): no
// transposes. kv head = q head / (Hq/Hkv), as the TPU index map.
//
// Bound: operations. 4*dh flops per live (query, key) pair against
// 2*(Sq*Hq + 2*Sk*Hkv)*dh input and output elements; at the model's shapes
// (S=4096, dh=128) ~500 flops per byte, above the H100's ~295 bf16 ridge.
// The float32 kernel does the two products on the CUDA cores (a 16x16
// thread grid, each thread a 4x4 block of scores and a 4 x dh/16 block of
// the output, operands from shared memory with odd row strides), so it is
// bound by the f32 FMA rate, not by the tensor-core bound.
//
// Numerics, as the TPU kernel: scores = (q.k) / sqrt(dh) in float32, masked
// entries set to the -1e30 sentinel (not -inf: a row's first live tile can
// be all masked for that row, which then adds exp(0) terms that the next
// live tile wipes with alpha = 0, as on the TPU), out = acc / max(l, 1e-30)
// cast to q's dtype. Key tiles outside the live range [k_lo, k_hi) of the q
// tile are skipped, not iterated; keys past Sk are zero-filled and masked. A
// row with no key at all (causal, Sq > Sk) is written as 0, which the TPU
// kernel gives where all its tiles skip (the Python wrapper rejects such
// shapes). The bfloat16 kernel adds one rounding, of p to bf16 before the
// PV product (see its section).
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hopper = repro::hopper;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int TPB = 256;      // 16 x 16 threads
constexpr int RPT = BQ / 16;  // rows per thread
constexpr int KPT = BK / 16;  // keys per thread
constexpr int LP = BK + 1;    // padded row of the probability tile
constexpr float NEG = -1e30f;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * LP);
}

template <int DH>
__global__ void __launch_bounds__(TPB, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Sq, int Sk, int Hq, int Hkv, int causal,
                       int has_window, int window) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = DH + 1;      // odd row stride: no bank conflicts
  constexpr int CPT = DH / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // BQ x LD
  float* Ks = Qs + BQ * LD;       // BK x LD
  float* Vs = Ks + BK * LD;       // BK x DH
  float* Ps = Vs + BK * DH;       // BQ x LP

  // the heaviest q tiles (the last, under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = min(BQ, Sq - q0);
  const int shift = Sk - Sq;      // right alignment: q_pos = shift + i
  const long long qrs = (long long)Hq * DH, krs = (long long)Hkv * DH;
  const float* qb = q + ((long long)b * Sq * Hq + h) * DH;
  const float* kb = k + ((long long)b * Sk * Hkv + hk) * DH;
  const float* vb = v + ((long long)b * Sk * Hkv + hk) * DH;
  float* ob = out + ((long long)b * Sq * Hq + h) * DH;

  // live keys of this q tile: [k_lo, k_hi)
  const int lo_q = shift + q0, hi_q = shift + q0 + nq - 1;
  const int k_hi = causal ? min(Sk, hi_q + 1) : Sk;
  const int k_lo = has_window ? max(0, lo_q - window + 1) : 0;
  const float sqrt_dh = sqrtf((float)DH);

  for (int i = tid; i < BQ * DH; i += TPB) {
    const int r = i / DH, d = i - r * DH;
    Qs[r * LD + d] = r < nq ? qb[(q0 + r) * qrs + d] : 0.0f;
  }
  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's K/V/P reads are done
    for (int i = tid; i < BK * DH; i += TPB) {
      const int r = i / DH, d = i - r * DH;
      const int kk = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (kk < Sk) {
        kv = kb[kk * krs + d];
        vv = vb[kk * krs + d];
      }
      Ks[r * LD + d] = kv;
      Vs[r * DH + d] = vv;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each of this thread's rows;
    // the 16 threads of a row (one half-warp) reduce with shuffles
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
      const int qpos = shift + q0 + r;
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] / sqrt_dh : NEG;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * LP + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const bool empty = causal && shift + q0 + r < 0;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + (q0 + r) * qrs;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = empty ? 0.0f : acc[i][c] / denom;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   long long B, long long Sq, long long Sk, int Hq, int Hkv,
                   int causal, int has_window, int window, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = flash_attention_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  REPRO_NOTE_LAUNCH(kern, smem);
  kern<<<grid, TPB, smem, s>>>(static_cast<const float*>(q),
                               static_cast<const float*>(k),
                               static_cast<const float*>(v), static_cast<float*>(out),
                               (int)Sq, (int)Sk, Hq, Hkv, causal, has_window,
                               window);
  return cudaGetLastError();
}

cudaError_t dispatch(int dh, const void* q, const void* k, const void* v,
                     void* out, long long B, long long Sq, long long Sk, int Hq,
                     int Hkv, int causal, int has_window, int window,
                     cudaStream_t s) {
  switch (dh) {
    case 16: return launch<16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    case 32: return launch<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    case 64: return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    case 80: return launch<80>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bfloat16: the tensor-core kernel ------------------------------------
//
// One block owns one (batch, q head, 128-row q tile): two consumer
// warpgroups of 64 rows each and one producer warp. The producer loads the
// q tile once and streams the live 128-key K and V tiles through a ring of
// KV_STAGES stages with TMA (tensor maps over the (B,S,H,dh) model layout,
// read in place: the head axis is one more map dimension, and rows past S
// arrive zero-filled). Each stage has a K and a V "full" barrier (completed
// by the copies' byte counts) and an "empty" barrier (completed when the 8
// consumer warps have finished the tile), so tile j+1 loads while tile j is
// multiplied.
//
// Per tile, each consumer warpgroup runs S = Q K^T as m64n128k16 wgmmas (both
// operands from shared memory, K-major), masks and updates the online
// softmax on the accumulator fragments (a thread holds 2 rows; row max and
// sum reduce over the 4 lanes of a row), converts p to bf16 in registers and
// runs O += P V as m64n{w}k16 wgmmas with P as the register A operand and V
// from shared memory through the transpose bit (V is MN-major). m, l and O
// stay in float32 registers. Each warpgroup waits for its own products;
// the two warpgroups of a block overlap one's softmax with the other's
// products. (Tried on the H100 against this schedule at the llama shape:
// issuing tile j+1's S before tile j's softmax, FA3's order, a named-
// barrier turn between the warpgroups, a third consumer warpgroup and Q
// held in registers were each no faster; what moved the time was the
// softmax's per-tile instruction count, hence 128-key tiles, the one-FFMA
// exponent and the skipped unit rescale below.)
//
// Head dims: dh is cut into 64-column slabs (128-byte rows, 128-byte
// swizzle) and a remainder slab of 16 or 32 columns (32- or 64-byte rows and
// swizzle), each slab its own TMA box and its own wgmma operand: 128 = 64+64,
// 80 = 64+16, 64, 32, 16. Every listed width takes the TMA route.
//
// Numerics: the products are exact bf16 x bf16 in float32 sums; scores are
// masked with the -1e30 sentinel in raw units and p = 2^(s c - m c), c =
// log2(e) / sqrt(dh), one FFMA and the hardware ex2 (relative error ~2^-22).
// attention_tiled_ref in ref.py computes p the same way; the scores' other
// summation order still moves p by float32 ulps, which can send a p near a
// bf16 tie to the other neighbour: p_rounding_slack allows one bf16 ulp
// where p lies within 2^-16 of a tie, and repro_flash_attention_bf16_p
// (below) lets the on-card check measure how far this kernel's p lies from
// the yardstick's. A row whose keys so far are all masked takes p = 0, not the
// TPU kernel's exp(0) terms: the next live tile's alpha = 0 wipes those
// anyway, so the output is the same. The design's one rounding beyond the
// CUDA-core kernel: the unnormalised p = exp(s - m_running) is rounded to
// bf16 before the PV product (as the plain version's probs.to(q.dtype) and
// every tensor-core flash kernel do), while the row sum l is taken from the
// float32 p. The output is acc / max(l, 1e-30) rounded once to bf16.
//
// Bound: operations (4 dh flops per live pair at the bf16 tensor-core rate).

namespace tc {

constexpr int BQ = 128;            // query rows per block (2 warpgroups)
constexpr int BK = 128;            // keys per tile
constexpr int KV_STAGES = 2;
constexpr int CONSUMERS = 256;     // 2 warpgroups
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp

template <int DH>
struct Geo {
  static constexpr int NFULL = DH / 64;          // 64-column slabs
  static constexpr int REM = DH % 64;            // 0, 16 or 32
  static constexpr int NSLAB = NFULL + (REM ? 1 : 0);
  static_assert(REM == 0 || REM == 16 || REM == 32, "head dim slabs");
  __host__ __device__ static constexpr int width(int s) { return s < NFULL ? 64 : REM; }
  __host__ __device__ static constexpr int col0(int s) { return 64 * s; }
  // byte offset of slab s in a tile of `rows` rows (slabs stored one after
  // the other, each rows x width(s) bf16)
  __host__ __device__ static constexpr int slab_off(int s, int rows) {
    return 2 * rows * col0(s);
  }
  static constexpr int Q_BYTES = 2 * BQ * DH;
  static constexpr int KV_BYTES = 2 * BK * DH;   // one K or V tile
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * KV_STAGES * KV_BYTES;
};

struct Maps {   // tensor maps: the 64-column slabs' and the remainder's
  CUtensorMap qf, qr, kf, kr, vf, vr;
};

__device__ __forceinline__ float ex2(float x) {   // 2^x, flushing denormals
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__device__ __forceinline__ void load_tile(const Maps& m, bool is_q, bool is_k,
                                          uint8_t* dst, uint64_t* bar, int rows,
                                          int h, int row0, int b) {
  using G = Geo<DH>;
#pragma unroll
  for (int s = 0; s < G::NSLAB; ++s) {
    const CUtensorMap* map =
        is_q ? (s < G::NFULL ? &m.qf : &m.qr)
             : is_k ? (s < G::NFULL ? &m.kf : &m.kr) : (s < G::NFULL ? &m.vf : &m.vr);
    hopper::tma_load_4d(dst + G::slab_off(s, rows), map, bar, G::col0(s), h, row0,
                        b);
  }
}

// DUMP_P (a check's instantiation, never on a path): block (0, 0, 0) also
// writes the float32 p of each of its live tiles, before the bf16 rounding,
// to p_dump[r * Sk + key] (r < 128: its q tile's rows)
template <int DH, bool DUMP_P>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel_bf16_wgmma(const __grid_constant__ Maps maps,
                                  __nv_bfloat16* __restrict__ out, int Sq,
                                  int Sk, int Hq, int Hkv, int causal,
                                  int has_window, int window,
                                  float* __restrict__ p_dump) {
  using G = Geo<DH>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_k[KV_STAGES], full_v[KV_STAGES], empty[KV_STAGES];
  __shared__ uint64_t q_full;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + G::Q_BYTES;                    // KV_STAGES K tiles
  uint8_t* Vs = Ks + KV_STAGES * G::KV_BYTES;       // KV_STAGES V tiles

  // the heaviest q tiles (the last, under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int nq = min(BQ, Sq - q0);
  const int shift = Sk - Sq;      // right alignment: q_pos = shift + i
  const int lo_q = shift + q0, hi_q = shift + q0 + nq - 1;
  const int k_hi = causal ? min(Sk, hi_q + 1) : Sk;
  const int k_lo = has_window ? max(0, lo_q - window + 1) : 0;
  const int k_start = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_start ? (k_hi - k_start + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::mbar_init(&q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warp: one lane issues every copy
    if (tid == CONSUMERS) {
      hopper::mbar_expect_tx(&q_full, G::Q_BYTES);
      load_tile<DH>(maps, true, false, Qs, &q_full, BQ, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % KV_STAGES, n = j / KV_STAGES;
        if (n > 0) hopper::mbar_wait(&empty[s], (n - 1) & 1);
        const int k0 = k_start + j * BK;
        hopper::mbar_expect_tx(&full_k[s], G::KV_BYTES);
        load_tile<DH>(maps, false, true, Ks + s * G::KV_BYTES, &full_k[s], BK, hk, k0, b);
        hopper::mbar_expect_tx(&full_v[s], G::KV_BYTES);
        load_tile<DH>(maps, false, false, Vs + s * G::KV_BYTES, &full_v[s], BK, hk, k0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups
  const int wg = tid / 128, lane = tid & 31, warp = (tid & 127) / 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;   // rows r0 and r0 + 8
  const int qp0 = shift + q0 + r0, qp1 = qp0 + 8;
  const int wq_lo = shift + q0 + wg * 64, wq_hi = wq_lo + 63;
  const float scale = 1.4426950408889634f / sqrtf((float)DH);   // log2(e)/sqrt(dh)

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

  hopper::mbar_wait(&q_full, 0);
  const uint32_t q_addr = hopper::smem_u32(Qs);
  const uint32_t k_addr = hopper::smem_u32(Ks);
  const uint32_t v_addr = hopper::smem_u32(Vs);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % KV_STAGES;
    const unsigned par = (j / KV_STAGES) & 1;
    const int k0 = k_start + j * BK;

    // S = Q K^T over dh in steps of 16
    float sc[BK / 2];
    hopper::mbar_wait(&full_k[s], par);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) hopper::fence_operand(sc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const int slab = (16 * ks) / 64;
      const uint32_t rb = 2 * G::width(slab);                 // row bytes
      const uint32_t koff = 2 * (16 * ks - G::col0(slab));    // within the row
      const uint64_t da = hopper::make_desc(
          q_addr + G::slab_off(slab, BQ) + wg * 64 * rb + koff, rb);
      const uint64_t db = hopper::make_desc(
          k_addr + s * G::KV_BYTES + G::slab_off(slab, BK) + koff, rb);
      hopper::wgmma_ss_n128(sc, da, db, ks > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) hopper::fence_operand(sc[i]);

    // mask (only tiles that cross a boundary of this warpgroup's rows)
    const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= wq_lo) &&
                      (!has_window || k0 > wq_hi - window);
    if (!full) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const int qp = (i & 2) ? qp1 : qp0;
        bool ok = key < Sk;
        if (causal) ok = ok && key <= qp;
        if (has_window) ok = ok && key > qp - window;
        if (!ok) sc[i] = NEG;
      }
    }
    // online softmax on the fragments
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = ex2((m0 - mn0) * scale), alpha1 = ex2((m1 - mn1) * scale);
    m0 = mn0;
    m1 = mn1;
    // p = 2^(s*scale - m*scale), one FFMA; a row whose keys so far are all
    // masked (m still the sentinel) gets p = 0 where the sentinel's own
    // rounding would give inf; the next live tile's alpha = 0 wipes what
    // such a row holds either way
    const float ms0 = mn0 == NEG ? 0.0f : mn0 * scale;
    const float ms1 = mn1 == NEG ? 0.0f : mn1 * scale;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      sc[i] = ex2(fmaf(sc[i], scale, -ms0));
      sc[i + 1] = ex2(fmaf(sc[i + 1], scale, -ms0));
      sc[i + 2] = ex2(fmaf(sc[i + 2], scale, -ms1));
      sc[i + 3] = ex2(fmaf(sc[i + 3], scale, -ms1));
      ps0 += sc[i] + sc[i + 1];
      ps1 += sc[i + 2] + sc[i + 3];
    }
    if constexpr (DUMP_P) {
      if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
          const int r = r0 + ((i & 2) ? 8 : 0);
          if (r < nq && key < Sk) p_dump[(long long)r * Sk + key] = sc[i];
        }
      }
    }
    l0 = l0 * alpha0 + ps0;      // per-thread partial sums: l is reduced
    l1 = l1 * alpha1 + ps1;      // over the row's 4 lanes once, at the end
    if (__any_sync(0xffffffffu, alpha0 != 1.0f || alpha1 != 1.0f)) {
#pragma unroll
      for (int i = 0; i < DH / 2; i += 4) {
        o[i] *= alpha0;
        o[i + 1] *= alpha0;
        o[i + 2] *= alpha1;
        o[i + 3] *= alpha1;
      }
    }
    // P (bf16, registers) as the A operand: the accumulator layout of keys
    // 16kk..16kk+15 is the A fragment layout of k-step kk
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V, one wgmma per (k-step, slab)
    hopper::mbar_wait(&full_v[s], par);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) hopper::fence_operand(o[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int slab = 0; slab < G::NSLAB; ++slab) {
        const uint32_t rb = 2 * G::width(slab);
        const uint64_t db = hopper::make_desc(
            v_addr + s * G::KV_BYTES + G::slab_off(slab, BK) + 16 * kk * rb, rb);
        float* os = o + G::col0(slab) / 2;
        if (G::width(slab) == 64)
          hopper::wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(os), pa[kk], db);
        else if (G::width(slab) == 32)
          hopper::wgmma_rs_n32(*reinterpret_cast<float(*)[16]>(os), pa[kk], db);
        else
          hopper::wgmma_rs_n16(*reinterpret_cast<float(*)[8]>(os), pa[kk], db);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) hopper::fence_operand(o[i]);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // epilogue: the row sums over the 4 lanes of a row, then bf16 stores
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const bool empty0 = causal && qp0 < 0, empty1 = causal && qp1 < 0;
  const long long qrs = (long long)Hq * DH;
  __nv_bfloat16* ob = out + ((long long)b * Sq * Hq + h) * DH;
#pragma unroll
  for (int J = 0; J < DH / 8; ++J) {
    const int col = 8 * J + 2 * (lane & 3);
    if (r0 < nq)
      *reinterpret_cast<uint32_t*>(ob + (q0 + r0) * qrs + col) =
          empty0 ? 0u : pack_bf16(o[4 * J] / d0, o[4 * J + 1] / d0);
    if (r0 + 8 < nq)
      *reinterpret_cast<uint32_t*>(ob + (q0 + r0 + 8) * qrs + col) =
          empty1 ? 0u : pack_bf16(o[4 * J + 2] / d1, o[4 * J + 3] / d1);
  }
}

}  // namespace tc

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A map over a (B,S,H,dh) bf16 tensor whose box is `rows` rows of one head
// and `width` columns, swizzled by the box's row length (32, 64 or 128 B).
bool encode_map(CUtensorMap* map, const void* base, int dh, int H, long long S,
                long long B, int width, int rows) {
  auto fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)H * dh * 2,
                                 (cuuint64_t)S * H * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)width, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, bool DUMP_P>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      long long B, long long Sq, long long Sk, int Hq, int Hkv,
                      int causal, int has_window, int window, float* p_dump,
                      cudaStream_t s) {
  using G = tc::Geo<DH>;
  if (Sk == 0)   // no key: every row is acc / max(l, 1e-30) = 0
    return cudaMemsetAsync(out, 0, (size_t)B * Sq * Hq * DH * 2, s);
  // the maps are encoded per call (the pointers change); the remainder
  // map of a width without one repeats the 64-column map
  const int wf = G::NFULL ? 64 : G::REM, wr = G::REM ? G::REM : 64;
  tc::Maps m;
  if (!encode_map(&m.qf, q, DH, Hq, Sq, B, wf, tc::BQ) ||
      !encode_map(&m.qr, q, DH, Hq, Sq, B, wr, tc::BQ) ||
      !encode_map(&m.kf, k, DH, Hkv, Sk, B, wf, tc::BK) ||
      !encode_map(&m.kr, k, DH, Hkv, Sk, B, wr, tc::BK) ||
      !encode_map(&m.vf, v, DH, Hkv, Sk, B, wf, tc::BK) ||
      !encode_map(&m.vr, v, DH, Hkv, Sk, B, wr, tc::BK))
    return cudaErrorInvalidValue;
  auto kern = tc::flash_attention_kernel_bf16_wgmma<DH, DUMP_P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + tc::BQ - 1) / tc::BQ), (unsigned)Hq, (unsigned)B);
  REPRO_NOTE_LAUNCH(kern, G::SMEM);
  kern<<<grid, tc::THREADS, G::SMEM, s>>>(m, static_cast<__nv_bfloat16*>(out),
                                           (int)Sq, (int)Sk, Hq, Hkv, causal,
                                           has_window, window, p_dump);
  return cudaGetLastError();
}

template <bool DUMP_P>
cudaError_t dispatch_tc(int dh, const void* q, const void* k, const void* v,
                        void* out, long long B, long long Sq, long long Sk,
                        int Hq, int Hkv, int causal, int has_window, int window,
                        float* p_dump, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_tc<16, DUMP_P>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, p_dump, s);
    case 32: return launch_tc<32, DUMP_P>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, p_dump, s);
    case 64: return launch_tc<64, DUMP_P>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, p_dump, s);
    case 80: return launch_tc<80, DUMP_P>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, p_dump, s);
    case 128: return launch_tc<128, DUMP_P>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, p_dump, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Sq,Hq,dh), k/v (B,Sk,Hkv,dh) -> out (B,Sq,Hq,dh), contiguous, one type.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, long long B, long long Sq,
                                     long long Sk, int Hq, int Hkv, int dh,
                                     int causal, int has_window, int window,
                                     int is_bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? dispatch_tc<false>(dh, q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window,
                           window, nullptr, s)
      : dispatch(dh, q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
  return (int)err;
}

// The bf16 kernel's check instantiation: as repro_flash_attention on bf16
// inputs, and block (0, 0, 0) (batch 0, q head 0, the last q tile: rows
// 128 * (ceil(Sq / 128) - 1) on) also writes the float32 p of its live tiles,
// before their bf16 rounding, to p_dump (128, Sk) f32, p relative to the
// row's running max at the key's tile; entries it does not reach keep what
// the caller put there. For the on-card checks only: no path calls it.
extern "C" int repro_flash_attention_bf16_p(const void* q, const void* k,
                                            const void* v, void* out,
                                            void* p_dump, long long B,
                                            long long Sq, long long Sk, int Hq,
                                            int Hkv, int dh, int causal,
                                            int has_window, int window,
                                            void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch_tc<true>(dh, q, k, v, out, B, Sq, Sk, Hq, Hkv, causal,
                                has_window, window, static_cast<float*>(p_dump),
                                static_cast<cudaStream_t>(stream));
}

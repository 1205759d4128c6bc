// Flash attention forward: online-softmax attention with GQA, causal and
// sliding-window masks, right-aligned query positions.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_bhsd
// (the pallas_call at line 112, body _flash_kernel at line 37). The TPU
// kernel walks a (B*Hq, q tiles, k tiles) grid whose k axis runs in order
// and carries the running max, denominator and accumulator across k steps
// in VMEM scratch. A GPU runs blocks in no order, so the k loop moves inside
// the block: one block owns one (batch, q head, 64-row q tile), loops over
// the live 64-key tiles staged in shared memory, keeps m, l and the output
// accumulator in float32 registers, and writes its output rows once.
//
// Layout: q (B,Sq,Hq,dh) and k, v, out (B,Sk,Hkv,dh) / (B,Sq,Hq,dh), the
// model layout, read in place through their row strides (H*dh): no
// transposes. kv head = q head / (Hq/Hkv), as the TPU index map.
//
// Bound: operations. 4*dh flops per live (query, key) pair against
// 2*(Sq*Hq + 2*Sk*Hkv)*dh input and output elements; at the model's shapes
// (S=4096, dh=128) ~500 flops per byte, above the H100's ~295 bf16
// ridge. This first version does the two products on the CUDA cores in
// float32 (a 16x16 thread grid, each thread a 4x4 block of scores and a
// 4 x dh/16 block of the output, operands from shared memory with odd row
// strides), so it cannot reach the tensor-core bound; wgmma / TMA and a
// warp-specialised pipeline are later work.
//
// Numerics, as the TPU kernel: bf16 or f32 inputs widened to float32,
// scores = (q.k) / sqrt(dh), masked entries set to the -1e30 sentinel (not
// -inf: a row's first live tile can be all masked for that row, which then
// adds exp(0) terms that the next live tile wipes with alpha = 0, as on the
// TPU), out = acc / max(l, 1e-30) cast to q's dtype. Key tiles outside the
// live range [k_lo, k_hi) of the q tile are skipped, not iterated; keys past
// Sk are zero-filled and masked. A row with no key at all (causal, Sq > Sk)
// is written as 0, which the TPU kernel gives where all its tiles skip (the
// Python wrapper rejects such shapes).
#include "common.cuh"

namespace {

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

template <typename T, int DH>
__global__ void __launch_bounds__(TPB, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
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
  const T* qb = q + ((long long)b * Sq * Hq + h) * DH;
  const T* kb = k + ((long long)b * Sk * Hkv + hk) * DH;
  const T* vb = v + ((long long)b * Sk * Hkv + hk) * DH;
  T* ob = out + ((long long)b * Sq * Hq + h) * DH;

  // live keys of this q tile: [k_lo, k_hi)
  const int lo_q = shift + q0, hi_q = shift + q0 + nq - 1;
  const int k_hi = causal ? min(Sk, hi_q + 1) : Sk;
  const int k_lo = has_window ? max(0, lo_q - window + 1) : 0;
  const float sqrt_dh = sqrtf((float)DH);

  for (int i = tid; i < BQ * DH; i += TPB) {
    const int r = i / DH, d = i - r * DH;
    Qs[r * LD + d] = r < nq ? repro::to_f32(qb[(q0 + r) * qrs + d]) : 0.0f;
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
        kv = repro::to_f32(kb[kk * krs + d]);
        vv = repro::to_f32(vb[kk * krs + d]);
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
    T* orow = ob + (q0 + r) * qrs;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      orow[tx + 16 * c] = repro::from_f32<T>(empty ? 0.0f : acc[i][c] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   long long B, long long Sq, long long Sk, int Hq, int Hkv,
                   int causal, int has_window, int window, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = flash_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  kern<<<grid, TPB, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                               static_cast<const T*>(v), static_cast<T*>(out),
                               (int)Sq, (int)Sk, Hq, Hkv, causal, has_window,
                               window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v,
                     void* out, long long B, long long Sq, long long Sk, int Hq,
                     int Hkv, int causal, int has_window, int window,
                     cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    case 80: return launch<T, 80>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
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
      ? dispatch<__nv_bfloat16>(dh, q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s)
      : dispatch<float>(dh, q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, has_window, window, s);
  return (int)err;
}

// The gated AdamW update of the fused train step, in place.
//
// Replaces: src/repro/kernels/fused_train_step/kernel.py, the epilogue of
// fused_train_step_pallas / fused_train_step_sampling_pallas /
// fused_train_step_sampling_tiled_pallas (`_adamw` at lines 218-256: the
// last batch tile of each partition applies AdamW to the gradients the
// earlier tiles accumulated). That relies on the TPU running the grid in
// order; on the GPU the gradients are complete only when the train-step
// kernel (train_step.cuh) has ended, so this is a second launch on the same
// stream: one thread per parameter over the four state groups (tables,
// input layer, hidden slab, output layer) of every partition.
//
// Per parameter, with the (P, 4) row [lr, 1-b1^t, 1-b2^t, gate] of its
// partition: m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2 (moments advance
// even where the gate is 0, as AdamW.step's); delta = (m / bc1) /
// (sqrt(v / bc2) + eps) + wd * p; p += gate * (-lr * delta). Every product
// and sum is rounded on its own (__fmul_rn / __fadd_rn, IEEE division and
// square root), so the build's FMA contraction cannot fuse them: from the
// same gradients the result is bit-exact against the plain version
// (fused_train_step/ref.py, adamw_apply_ref). The params, m and v are
// overwritten in place (the JAX package donates their buffers). The kernel
// also writes the step's mean loss, loss_sum / (N D_out).
//
// The bf16 policy's variant (adamw_kernel<true>) keeps the float32 master
// copy of kernel.py's has_master leg (lines 224-231, 251-253): the update
// reads and writes the master in place of p, with the same operations in
// the same order, and the bfloat16 params are re-derived from the new
// master by round-to-nearest-even, as AdamW.step casts them.
//
// The deterministic route (train_step.cuh, DET) hands over no float32
// gradient buffer: the kernel sums each MLP weight's per-group rows of the
// (P, groups, n_w + 1) partials in group order (and the loss from their last
// column), and converts each table entry's int64 fixed-point sum to float32
// (hash_grid.cuh: value = sum * 2^-47, through double, rounded once). A
// partition whose flag is set (a contribution past the fixed-point bound,
// or not finite) gets NaN gradients and a NaN loss, and its flag is ORed
// into `overflow` for the trainer to read. The update itself is unchanged.
//
// That route's kernel (adamw_det_kernel) splits its roles inside one launch.
// The first blocks sum the group rows, CHAIN_COLS columns of a partition's
// rows (the dW columns and the loss) a block: its 8 warps stage
// CHAIN_ROWS group rows of those columns in shared memory (a warp's row
// one or two 128-byte lines, each thread CHAIN_ROWS / 8 loads in flight),
// then warp 0 adds them in group order with __fadd_rn from 0, a lane a
// column, and updates the column's MLP weight (or writes its partition's
// loss). The other blocks stream the tables' int64 entries four at a time
// (16-byte loads of the state, two of the fixed point) with no group
// search. The chain blocks come first in the grid, so they start with the
// stream and hide under it. The design before it, every parameter through
// one grid-stride loop that left the MLP columns' chains (eight loads in
// flight) to its last iterations, is kept as the yardstick
// (adamw_kernel<MASTER, true>, design 1 of the entry). A first build of the
// split, a thread a column with 16 loads ahead of its adds, left the chains
// a 0.022 ms tail past the stream on the card.
//
// Bound: bytes. Each parameter reads 4 floats (p, m, v, g) and writes 3:
// 28 B against ~15 flops. PRODUCTION256's 8 partitions hold 1.3M parameters,
// 37 MB moved, 11 us at 3.35 TB/s. With a master, each reads mw, m, v and g
// and writes mw, m, v and a bfloat16 p: 30 B, 39 MB, 12 us.
#include "common.cuh"
#include "hash_grid.cuh"

namespace {

struct Group {
  float* p;              // the params (float32 policy)
  float* m;
  float* v;
  const float* g;
  float* mw;             // the float32 master (bf16 policy), else null
  __nv_bfloat16* pb;     // the bfloat16 params derived from it, else null
  long long n;   // parameters per partition (0: the group is skipped)
  int col;       // the deterministic route: its first column in a partials row
};

struct Groups {
  Group k[4];
};

// the deterministic route's gradients (see the header); partials null on the
// default route
struct Det {
  const float* partials;             // (P, groups, cols)
  long long groups;
  int cols;                          // n_w + 1: the last column is the loss
  const unsigned long long* tab_fx;  // (P, n_tab) int64 fixed point
  const unsigned long long* flags;   // (P,)
  unsigned long long* overflow;      // (P,) ORed with flags, or null
};

// column `col` of partition p's partials rows summed in group order
__device__ __forceinline__ float group_sum(const Det& d, long long p, int col) {
  const float* x = d.partials + p * d.groups * d.cols + col;
  float s = 0.0f;
#pragma unroll 8
  for (long long i = 0; i < d.groups; ++i) s = __fadd_rn(s, x[i * d.cols]);
  return s;
}

__device__ __forceinline__ float from_fixed(unsigned long long q) {
  return __double2float_rn(__ll2double_rn((long long)q) *
                           (1.0 / (double)(1LL << repro::FX_SHIFT)));
}

// the update's constants (as adamw_kernel's arguments)
struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

// one parameter's AdamW step: the moments advanced in place and the new
// weight returned, every product and sum rounded once in adamw_kernel's
// order
__device__ __forceinline__ float adam_step(float g, float w, float& m, float& v,
                                           const float4 sc, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float delta = __fdiv_rn(__fdiv_rn(m, sc.y), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, sc.z)), h.eps));
  if (h.wd != 0.0f) delta = __fadd_rn(delta, __fmul_rn(h.wd, w));
  return __fadd_rn(w, __fmul_rn(sc.w, __fmul_rn(-sc.x, delta)));
}

// partition p's [lr, 1-b1^t, 1-b2^t, gate]
__device__ __forceinline__ float4 schedule(const float* scalars, long long p) {
  return make_float4(__ldg(scalars + 4 * p), __ldg(scalars + 4 * p + 1),
                     __ldg(scalars + 4 * p + 2), __ldg(scalars + 4 * p + 3));
}

// the chain blocks' columns and the group rows they stage at a time
constexpr int CHAIN_COLS = 32;
constexpr int CHAIN_ROWS = 128;
constexpr int DET_THREADS = 256;

// The chain role of adamw_det_kernel (a whole block): lane l of warp 0
// takes column c of partition p's (groups, cols) rows, i = blockIdx.x *
// CHAIN_COLS + l flattened over the partitions; the block stages the
// rows in `rows`, warp 0 sums each column in group order from 0 and
// updates the MLP weight of that column, or writes the loss (the last
// column) and ORs the flag into overflow.
template <bool MASTER>
__device__ __forceinline__ void det_chain(const Groups& gs, const Det& d,
                                          const float* __restrict__ scalars,
                                          float* __restrict__ loss, long long P,
                                          float loss_div, const Hyper& h,
                                          float (*rows)[CHAIN_COLS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long cols = d.cols, i = (long long)blockIdx.x * CHAIN_COLS + lane;
  const bool valid = i < P * cols;
  const long long p = valid ? i / cols : 0;
  const int c = (int)(i - p * cols);
  const float* x = d.partials + p * d.groups * cols + c;
  float s = 0.0f;
  for (long long g0 = 0; g0 < d.groups; g0 += CHAIN_ROWS) {
    const int n = (int)min((long long)CHAIN_ROWS, d.groups - g0);
    float r[CHAIN_ROWS / 8];
#pragma unroll
    for (int u = 0; u < CHAIN_ROWS / 8; ++u)
      if (valid && warp + 8 * u < n) r[u] = __ldg(x + (g0 + warp + 8 * u) * cols);
#pragma unroll
    for (int u = 0; u < CHAIN_ROWS / 8; ++u)
      if (valid && warp + 8 * u < n) rows[warp + 8 * u][lane] = r[u];
    __syncthreads();
    if (warp == 0 && valid) {
#pragma unroll 8
      for (int g = 0; g < n; ++g) s = __fadd_rn(s, rows[g][lane]);
    }
    __syncthreads();   // read before the next rows land
  }
  if (warp != 0 || !valid) return;
  const unsigned long long f = d.flags[p];
  const float nan = __int_as_float(0x7fffffff);
  if (c == cols - 1) {
    loss[p] = f ? nan : __fdiv_rn(s, loss_div);
    if (d.overflow != nullptr) d.overflow[p] |= f;
    return;
  }
  int k = 1;   // the column's group: win, whid, wout from column 0
  while (k < 3 && c >= gs.k[k].col + gs.k[k].n) ++k;
  const Group& G = gs.k[k];
  const long long j = p * G.n + (c - G.col);
  float m = G.m[j], v = G.v[j];
  const float nw = adam_step(f ? nan : s, MASTER ? G.mw[j] : G.p[j], m, v,
                             schedule(scalars, p), h);
  G.m[j] = m;
  G.v[j] = v;
  if (MASTER) {
    G.mw[j] = nw;
    G.pb[j] = __float2bfloat16_rn(nw);
  } else {
    G.p[j] = nw;
  }
}

// The table role of adamw_det_kernel: the (P, n) table entries from
// `first` with a stride, four a unit where VEC (n % 4 == 0, 16-byte aligned
// state), else one.
template <bool MASTER, bool VEC>
__device__ __forceinline__ void det_tables(const Group& G, const Det& d,
                                           const float* __restrict__ scalars,
                                           long long P, const Hyper& h,
                                           long long first, long long stride) {
  constexpr int U = VEC ? 4 : 1;
  const long long n = G.n, units = P * n / U;
  const float nan = __int_as_float(0x7fffffff);
  float* const wp = MASTER ? G.mw : G.p;
  for (long long u = first; u < units; u += stride) {
    const long long j = U * u, p = j / n;
    const float4 sc = schedule(scalars, p);
    const bool bad = d.flags[p] != 0;
    if (VEC) {
      const ulonglong2* q = reinterpret_cast<const ulonglong2*>(d.tab_fx + j);
      const ulonglong2 q01 = __ldg(q), q23 = __ldg(q + 1);
      float4 m = *reinterpret_cast<const float4*>(G.m + j);
      float4 v = *reinterpret_cast<const float4*>(G.v + j);
      float4 w = *reinterpret_cast<const float4*>(wp + j);
      w.x = adam_step(bad ? nan : from_fixed(q01.x), w.x, m.x, v.x, sc, h);
      w.y = adam_step(bad ? nan : from_fixed(q01.y), w.y, m.y, v.y, sc, h);
      w.z = adam_step(bad ? nan : from_fixed(q23.x), w.z, m.z, v.z, sc, h);
      w.w = adam_step(bad ? nan : from_fixed(q23.y), w.w, m.w, v.w, sc, h);
      *reinterpret_cast<float4*>(G.m + j) = m;
      *reinterpret_cast<float4*>(G.v + j) = v;
      *reinterpret_cast<float4*>(wp + j) = w;
      if (MASTER) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(w.x, w.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(w.z, w.w);
        uint2 packed;
        packed.x = *reinterpret_cast<unsigned*>(&lo);
        packed.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(G.pb + j) = packed;
      }
    } else {
      float m = G.m[j], v = G.v[j];
      const float nw = adam_step(bad ? nan : from_fixed(d.tab_fx[j]), wp[j], m, v, sc, h);
      G.m[j] = m;
      G.v[j] = v;
      wp[j] = nw;
      if (MASTER) G.pb[j] = __float2bfloat16_rn(nw);
    }
  }
}

// The deterministic route's update, its roles split inside one launch (see
// the header): blocks [0, chain_blocks) the group rows' chains, the rest
// the table stream.
template <bool MASTER, bool VEC>
__global__ void __launch_bounds__(DET_THREADS, 4)
adamw_det_kernel(const Groups gs, const Det det, const float* __restrict__ scalars,
                 float* __restrict__ loss, long long P, int chain_blocks,
                 float loss_div, const Hyper h) {
  __shared__ float rows[CHAIN_ROWS][CHAIN_COLS];
  if ((int)blockIdx.x < chain_blocks) {
    det_chain<MASTER>(gs, det, scalars, loss, P, loss_div, h, rows);
    return;
  }
  det_tables<MASTER, VEC>(gs.k[0], det, scalars, P, h,
                          (long long)(blockIdx.x - chain_blocks) * DET_THREADS + threadIdx.x,
                          (long long)(gridDim.x - chain_blocks) * DET_THREADS);
}

// adamw_det_kernel's grid: the chain blocks (CHAIN_COLS columns of the
// partitions' rows a block), then the table blocks (a thread a unit of four
// entries where vec, else one; at most 16 blocks an SM, grid-stride beyond)
struct DetPlan {
  long long chain_blocks, table_blocks;
  int vec;
};

inline DetPlan det_plan(long long P, long long n_tab, long long cols, int sms, int aligned) {
  DetPlan plan;
  plan.vec = aligned && n_tab % 4 == 0;
  const long long units = P * n_tab / (plan.vec ? 4 : 1);
  plan.chain_blocks = (P * cols + CHAIN_COLS - 1) / CHAIN_COLS;
  const long long cap = 16LL * sms, need = (units + DET_THREADS - 1) / DET_THREADS;
  plan.table_blocks = need < cap ? need : cap;
  return plan;
}

// MASTER false: the float32 policy's update (the params are their own
// master); true: the bf16 policy's, the float32 master and then the bfloat16
// params
template <bool MASTER, bool DET>
__global__ void adamw_kernel(const Groups gs, const Det det,
                             const float* __restrict__ scalars,
                             const float* __restrict__ loss_sum,
                             float* __restrict__ loss, long long P,
                             long long total, float loss_div, float b1,
                             float omb1, float b2, float omb2, float eps,
                             float wd) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float nan = __int_as_float(0x7fffffff);
  for (long long q = first; q < P; q += stride) {
    if (DET) {
      const unsigned long long f = det.flags[q];
      loss[q] = f ? nan : __fdiv_rn(group_sum(det, q, det.cols - 1), loss_div);
      if (det.overflow != nullptr) det.overflow[q] |= f;
    } else {
      loss[q] = __fdiv_rn(loss_sum[q], loss_div);
    }
  }
  for (long long i = first; i < total; i += stride) {
    long long j = i;
    int k = 0;
    while (k < 3 && j >= P * gs.k[k].n) {   // a group with n = 0 is passed over
      j -= P * gs.k[k].n;
      ++k;
    }
    const Group& G = gs.k[k];
    const long long p = j / G.n;
    const float lr = __ldg(scalars + 4 * p), bc1 = __ldg(scalars + 4 * p + 1);
    const float bc2 = __ldg(scalars + 4 * p + 2), gate = __ldg(scalars + 4 * p + 3);
    float g;
    if (DET) {
      g = det.flags[p] ? nan
          : k == 0     ? from_fixed(det.tab_fx[j])
                       : group_sum(det, p, G.col + (int)(j - p * G.n));
    } else {
      g = G.g[j];
    }
    const float w = MASTER ? G.mw[j] : G.p[j];
    const float m = __fadd_rn(__fmul_rn(b1, G.m[j]), __fmul_rn(omb1, g));
    const float v = __fadd_rn(__fmul_rn(b2, G.v[j]), __fmul_rn(omb2, __fmul_rn(g, g)));
    float delta = __fdiv_rn(__fdiv_rn(m, bc1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
    if (wd != 0.0f) delta = __fadd_rn(delta, __fmul_rn(wd, w));
    G.m[j] = m;
    G.v[j] = v;
    const float nw = __fadd_rn(w, __fmul_rn(gate, __fmul_rn(-lr, delta)));
    if (MASTER) {
      G.mw[j] = nw;
      G.pb[j] = __float2bfloat16_rn(nw);
    } else {
      G.p[j] = nw;
    }
  }
}

}  // namespace

// Four groups of (params, m, v, grad, master) pointers, (P, n_k) each, with
// n_k parameters per partition (0 skips the group): float32 params and a
// null master (master = 0), or bfloat16 params and a float32 master
// (master = 1); m, v and grad float32. scalars (P,4) f32 rows
// [lr, 1-b1^t, 1-b2^t, gate]; loss_sum (P,) -> loss (P,) = loss_sum /
// loss_div. The constants arrive as float32 values of the host's doubles
// (1-b1 and 1-b2 are computed in double first, as the plain version's
// Python scalars are).
// The deterministic route: partials (P, groups, cols) non-null, tab_fx
// (P, n0) and flags (P,) int64 from repro_train_step (det = 1), overflow
// (P,) int64 or null; the grad pointers and loss_sum are not read, the
// groups' columns run win, whid, wout from 0 (a group with n = 0 has none).
// design 0 runs adamw_det_kernel (the route), 1 its yardstick, the
// grid-stride adamw_kernel<MASTER, true> (a measurement); the default route
// reads no design.
extern "C" int repro_adamw_apply(
    void* p0, void* m0, void* v0, const void* g0, void* mw0, long long n0,
    void* p1, void* m1, void* v1, const void* g1, void* mw1, long long n1,
    void* p2, void* m2, void* v2, const void* g2, void* mw2, long long n2,
    void* p3, void* m3, void* v3, const void* g3, void* mw3, long long n3,
    const void* scalars, const void* loss_sum, void* loss, long long P,
    float loss_div, float b1, float omb1, float b2, float omb2, float eps,
    float wd, int master, const void* partials, long long groups, int cols,
    const void* tab_fx, const void* flags, void* overflow, int design,
    void* stream) {
  if (P <= 0) return 0;
  const bool is_det = partials != nullptr;
  if (is_det && (tab_fx == nullptr || flags == nullptr || groups <= 0 ||
                 (long long)cols != 1 + n1 + n2 + n3))
    return (int)cudaErrorInvalidValue;
  const Det det{static_cast<const float*>(partials), groups, cols,
                static_cast<const unsigned long long*>(tab_fx),
                static_cast<const unsigned long long*>(flags),
                static_cast<unsigned long long*>(overflow)};
  Groups gs;
  void* ps[4] = {p0, p1, p2, p3};
  void* ms[4] = {m0, m1, m2, m3};
  void* vs[4] = {v0, v1, v2, v3};
  const void* gr[4] = {g0, g1, g2, g3};
  void* mws[4] = {mw0, mw1, mw2, mw3};
  const long long ns[4] = {n0, n1, n2, n3};
  long long total = 0;
  int col = 0;
  for (int k = 0; k < 4; ++k) {
    if (ns[k] < 0 || (master != 0) != (mws[k] != nullptr))
      return (int)cudaErrorInvalidValue;
    gs.k[k] = Group{master ? nullptr : static_cast<float*>(ps[k]),
                    static_cast<float*>(ms[k]), static_cast<float*>(vs[k]),
                    static_cast<const float*>(gr[k]), static_cast<float*>(mws[k]),
                    master ? static_cast<__nv_bfloat16*>(ps[k]) : nullptr, ns[k],
                    col};
    if (k > 0) col += (int)ns[k];
    total += P * ns[k];
  }
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (is_det && design == 0) {
    const Group& t = gs.k[0];
    const auto a16 = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
    const bool aligned = a16(tab_fx) && a16(t.m) && a16(t.v) &&
                         (master ? a16(t.mw) && reinterpret_cast<uintptr_t>(t.pb) % 8 == 0
                                 : a16(t.p));
    const DetPlan plan = det_plan(P, n0, cols, sms, aligned);
    const Hyper h{b1, omb1, b2, omb2, eps, wd};
    auto kernel = master ? (plan.vec ? &adamw_det_kernel<true, true> : &adamw_det_kernel<true, false>)
                         : (plan.vec ? &adamw_det_kernel<false, true> : &adamw_det_kernel<false, false>);
    REPRO_NOTE_LAUNCH(kernel, 0);
    kernel<<<(unsigned)(plan.chain_blocks + plan.table_blocks), DET_THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(
        gs, det, static_cast<const float*>(scalars), static_cast<float*>(loss), P,
        (int)plan.chain_blocks, loss_div, h);
    return (int)cudaGetLastError();
  }
  if (is_det && design != 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  auto kernel = master ? (is_det ? &adamw_kernel<true, true> : &adamw_kernel<true, false>)
                       : (is_det ? &adamw_kernel<false, true> : &adamw_kernel<false, false>);
  REPRO_NOTE_LAUNCH(kernel, 0);
  kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      gs, det, static_cast<const float*>(scalars), static_cast<const float*>(loss_sum),
      static_cast<float*>(loss), P, total, loss_div, b1, omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}

// out (3 int64, host memory) = (chain blocks, table blocks, vec) of
// adamw_det_kernel's grid for P partitions of n_tab table entries and cols
// columns of group rows on `sms` SMs, the state 16-byte aligned or not
extern "C" int repro_adamw_det_plan(long long P, long long n_tab, int cols, int sms,
                                    int aligned, void* out) {
  if (P < 0 || n_tab < 0 || cols < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const DetPlan plan = det_plan(P, n_tab, cols, sms, aligned);
  long long* o = static_cast<long long*>(out);
  o[0] = plan.chain_blocks;
  o[1] = plan.table_blocks;
  o[2] = plan.vec;
  return 0;
}

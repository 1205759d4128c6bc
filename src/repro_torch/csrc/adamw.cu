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
extern "C" int repro_adamw_apply(
    void* p0, void* m0, void* v0, const void* g0, void* mw0, long long n0,
    void* p1, void* m1, void* v1, const void* g1, void* mw1, long long n1,
    void* p2, void* m2, void* v2, const void* g2, void* mw2, long long n2,
    void* p3, void* m3, void* v3, const void* g3, void* mw3, long long n3,
    const void* scalars, const void* loss_sum, void* loss, long long P,
    float loss_div, float b1, float omb1, float b2, float omb2, float eps,
    float wd, int master, const void* partials, long long groups, int cols,
    const void* tab_fx, const void* flags, void* overflow, void* stream) {
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
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  auto kernel = master ? (is_det ? &adamw_kernel<true, true> : &adamw_kernel<true, false>)
                       : (is_det ? &adamw_kernel<false, true> : &adamw_kernel<false, false>);
  kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      gs, det, static_cast<const float*>(scalars), static_cast<const float*>(loss_sum),
      static_cast<float*>(loss), P, total, loss_div, b1, omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}

// The fused train step's C entries and its float32 instantiations (the
// kernel and its design: train_step.cuh; the bf16 policy's instantiations:
// train_step_bf16.cu).
#include "train_step.cuh"

namespace {

bool valid_levels(int L, int F) {
  return L >= 1 && L <= repro::STEP_MAX_LEVELS && (F == 1 || F == 2 || F == 4 || F == 8);
}

}  // namespace

// Plain mode (sampling = 0): coords (P,N,3), target (P,N,D_out).
// Sampling mode: volumes (P,nx,ny,nz,D_out) ghost-padded, seeds (P,2) uint32
// words held in int64, N = n_batch rows of which the first n_uniform are
// uniform. State: tab (P,L,T,F) (16-byte aligned), win (P,L*F,W), whid
// (P,n_hid_slab,W,W), wout (P,W,D_out), all float32 (is_bf16 = 0) or all
// bfloat16 (is_bf16 = 1: the bf16 policy's kernel). Outputs, zeroed by the
// caller and added into: g_tab / g_win / g_whid / g_wout (the state's
// shapes; g_tab 16-byte aligned) and loss_sum (P,) = sum over rows and
// outputs of |pred - target|. g_feat: null, or (P,N,L*F) f32 that takes the
// feature cotangent instead of g_tab. resolutions (L,) i32 in HOST memory,
// L <= 32.
// det = 1 takes the deterministic route (train_step.cuh): the g_* and
// loss_sum outputs are not written; g_tab_fx (P,L,T,F) int64 and flags (P,)
// int64, zeroed by the caller, take the fixed-point table gradient and the
// flag bits, and partials (P, groups, n_w + 1) f32 (groups from
// repro_train_step_shape) each group's dW and loss, written whole.
extern "C" int repro_train_step(
    const void* coords, const void* target, const void* volumes,
    const void* seeds, const void* tab, const void* win, const void* whid,
    const void* wout, void* g_tab, void* g_win, void* g_whid, void* g_wout,
    void* loss_sum, void* g_feat, void* g_tab_fx, void* partials, void* flags,
    const void* resolutions, long long P,
    long long N, int L, long long T, int F, int W, int n_hidden,
    int n_hid_slab, int D_out, long long nx, long long ny, long long nz,
    int ghost, long long n_uniform, float sigma, int sampling, int is_bf16,
    int det, void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (P > 65535 || n_hidden < 1 || D_out < 1 || D_out > repro::STEP_C_MAX ||
      !valid_levels(L, F) ||
      ((reinterpret_cast<uintptr_t>(tab) |
        reinterpret_cast<uintptr_t>(det ? g_tab_fx : g_tab)) & 15))
    return (int)cudaErrorInvalidValue;
  if (sampling ? (volumes == nullptr || seeds == nullptr)
               : (coords == nullptr || target == nullptr))
    return (int)cudaErrorInvalidValue;
  if (det && (g_tab_fx == nullptr || partials == nullptr || flags == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* res = static_cast<const int*>(resolutions);
  repro::StepShape sh;
  if (!repro::step_shape(L, F, W, n_hidden, D_out, N, P, det != 0, &sh))
    return (int)cudaErrorInvalidValue;
  repro::StepArgs a;
  a.coords = static_cast<const float*>(coords);
  a.target = static_cast<const float*>(target);
  a.vol = static_cast<const float*>(volumes);
  a.seeds = static_cast<const long long*>(seeds);
  a.tab = tab;
  a.win = win;
  a.whid = whid;
  a.wout = wout;
  a.g_tab = static_cast<float*>(g_tab);
  a.g_win = static_cast<float*>(g_win);
  a.g_whid = static_cast<float*>(g_whid);
  a.g_wout = static_cast<float*>(g_wout);
  a.loss_sum = static_cast<float*>(loss_sum);
  a.g_feat = static_cast<float*>(g_feat);
  a.g_tab_fx = static_cast<unsigned long long*>(g_tab_fx);
  a.partials = static_cast<float*>(partials);
  a.flags = static_cast<unsigned long long*>(flags);
  a.fx_vmax = repro::FX_BOUND / (float)N;
  a.N = N; a.T = T; a.nx = nx; a.ny = ny; a.nz = nz; a.n_uniform = n_uniform;
  a.L = L; a.D_in = L * F; a.n_hidden = n_hidden; a.n_hid_slab = n_hid_slab;
  a.D_out = D_out; a.ghost = ghost; a.sigma = sigma;
  for (int l = 0; l < L; ++l) a.res[l] = res[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool smp = sampling != 0;
  if (det) {
    return (int)(is_bf16 ? repro::train_step_launch_det_bf16(a, sh, P, W, F, smp, s)
                         : repro::train_step_launch_det(a, sh, P, W, F, smp, s));
  }
  if (is_bf16) return (int)repro::train_step_launch_bf16(a, sh, P, W, F, smp, s);
  return (int)repro::step_launch<float, false>(a, sh, P, W, F, smp, s);
}

// The train step's launch shape for these arguments (as repro_train_step
// takes them; shape in HOST memory): shape = {threads per block, blocks per
// partition, shared-memory bytes, the deterministic route's groups (0 for
// det = 0)}, for sizing its buffer and counting the scatter's requests.
extern "C" int repro_train_step_shape(long long P, long long N, int L, int F,
                                      int W, int n_hidden, int D_out, int det,
                                      void* shape) {
  repro::StepShape sh;
  if (!valid_levels(L, F) ||
      !repro::step_shape(L, F, W, n_hidden, D_out, N, P, det != 0, &sh))
    return (int)cudaErrorInvalidValue;
  long long* out = static_cast<long long*>(shape);
  out[0] = sh.tile;
  out[1] = sh.blocks;
  out[2] = (long long)sh.smem;
  out[3] = sh.groups;
  return 0;
}

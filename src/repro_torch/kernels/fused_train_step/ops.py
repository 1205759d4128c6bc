"""The fused train step: backend dispatch and the CUDA kernels' wrappers.

- backend kind ``torch`` (``ref``) -> :func:`ref.train_step_ref` /
  :func:`ref.train_step_sampling_ref` (autograd through the plain ops, then
  ``AdamW.step``);
- backend kind ``cuda`` -> two launches on the current stream:
  ``repro_train_step`` (``csrc/train_step.cuh``: [sampling,] encode, MLP
  forward, masked L1 cotangent, MLP backward and the 8-corner table scatter
  for every (partition, batch tile), gradients into a zeroed f32 buffer:
  same-row lanes summed per warp, then one 16-byte atomic per row) and
  ``repro_adamw_apply`` (``csrc/adamw.cu``: the gated
  AdamW update, one thread per parameter). The TPU kernel applies AdamW on
  the last batch tile because its grid runs in order; on the GPU that
  grid-wide dependency is the boundary between the two launches.

Precision policies: the train-step kernel runs in the compute dtype, float32
or bf16 (the bf16 kernel rounds where the plain version rounds, and its
gradients stay float32); params stored in another dtype than the compute
dtype are cast to it first, as the plain version and the JAX kernel cast
them (``tables.astype(cdt)``). The AdamW kernel updates float32 params, or
bf16 params through their float32 master (``opt["mw"]``). float16 and bf16
moments are refused.

The CUDA path updates the params, moments and master IN PLACE (the JAX
package donates them): the tensors of ``params`` / ``opt`` passed in hold
the new state afterwards, and the returned trees are views of them (the hidden
layers of a stacked MLP are views of one (P, H-1, W, W) slab). Clone a
state that must survive the step. On CPU tensors the two wrappers run their
plain versions (:func:`ref.train_step_grads_ref`,
:func:`ref.adamw_apply_ref`), with the same in-place contract.

The entry points work on the trainer's stacked (P, ...) state: the
partition axis is a kernel grid axis, not a loop.

Under ``torch.use_deterministic_algorithms(True)`` the CUDA path takes the
train step's deterministic route (``csrc/train_step.cuh``, DET): no float
atomics, so its gradients, loss sums and every later step are the same bits
run to run, and a partition trains to the same bits whatever the number of
partitions stacked beside it. The train-step kernel then hands AdamW a
:class:`DetGrads` (per-group dW and loss rows, an int64 fixed-point table
gradient) in place of float32 gradients; :func:`det_grads_to_float`
materialises them for checks.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch import backends
from repro_torch.core.sampling import batch_coords, n_boundary
from repro_torch.data.volume import sample_trilinear_batched
from repro_torch.kernels import build
from repro_torch.kernels.fixed_point import (FX_BOUND, FX_OVER, FX_SHIFT,  # noqa: F401
                                              FixedPointOverflowError)
from repro_torch.kernels.fused_mlp.ops import KERNEL_WIDTHS, SMEM_LIMIT
from repro_torch.kernels.fused_train_step import ref as _ref
from repro_torch.kernels.hash_encoding.ops import bwd_launch_plan, levels_arg
from repro_torch.optim.adamw import AdamW, OptConfig, bias_corrections
from repro_torch.precision import torch_dtype

STATE_KEYS = ("tab", "win", "whid", "wout")


def _hid_slab(hid):
    """The (P, H-1, W, W) slab of the hidden layers: the slab they are views
    of when they are (what :func:`_unpack` hands out, so an in-place update
    of the slab is an update of the layers), else a stacked copy."""
    base = hid[0]._base
    if base is not None and base.shape[1] == len(hid) and base.ndim == 4 \
            and all(h._base is base and h.data_ptr() == base[:, k].data_ptr()
                    and h.stride() == base[:, k].stride()
                    for k, h in enumerate(hid)):
        return base
    return torch.stack(hid, dim=1)


def _pack(tree_params):
    """{"tables": (P,L,T,F), "mlp": [...]} -> the four stacked state groups
    {tab, win, whid (P, max(H-1,1), W, W), wout} and H. An H = 1 MLP gets
    an all-zero dummy hidden slab, which no kernel reads or updates."""
    w_in, *hid, w_out = tree_params["mlp"]
    if hid:
        w_hid = _hid_slab(hid)
    else:
        w_hid = torch.zeros((w_in.shape[0], 1, w_in.shape[2], w_in.shape[2]),
                            dtype=w_in.dtype, device=w_in.device)
    return {"tab": tree_params["tables"], "win": w_in, "whid": w_hid,
            "wout": w_out}, len(hid) + 1


def _unpack(flat, n_hidden):
    mlp = [flat["win"]] + [flat["whid"][:, k] for k in range(n_hidden - 1)] \
        + [flat["wout"]]
    return {"tables": flat["tab"], "mlp": mlp}


def _check_kernel_opt(opt_cfg: OptConfig, backend, compute_dtype):
    """The kernel path's guards, as the JAX package's Pallas leg has them:
    no fused global-norm clipping, float32 moments, a compute dtype the
    backend runs (float32 or bf16)."""
    if opt_cfg.clip_norm:
        raise ValueError("the CUDA fused_train_step does not fuse global-norm "
                         "clipping (OptConfig.clip_norm must be 0)")
    if torch_dtype(opt_cfg.moments_dtype) != torch.float32:
        raise ValueError("the CUDA fused_train_step keeps f32 moments "
                         f"(got moments_dtype={opt_cfg.moments_dtype!r})")
    return None if compute_dtype is None else backend.require_dtype(compute_dtype)


def _pack_state(params, opt):
    flat_p, n_hidden = _pack(params)
    flat_m = _pack(opt["m"])[0]
    flat_v = _pack(opt["v"])[0]
    flat_mw = _pack(opt["mw"])[0] if "mw" in opt else None
    return flat_p, flat_m, flat_v, flat_mw, n_hidden


def schedule_table(opt_step: torch.Tensor, opt_cfg: OptConfig, adam: AdamW,
                   n_steps: int) -> torch.Tensor:
    """(n_steps, P, 4) rows of ``[lr, 1-b1^t, 1-b2^t, gate]`` for the next
    ``n_steps`` steps from the (P,) counter ``opt_step``; the gate column is
    1 (the trainer writes the convergence mask into it step by step)."""
    step = opt_step[None, :] + torch.arange(
        1, n_steps + 1, dtype=opt_step.dtype, device=opt_step.device)[:, None]
    bc1, bc2 = bias_corrections(opt_cfg, step)
    return torch.stack([adam.schedule(step), bc1, bc2,
                        torch.ones_like(bc1)], dim=-1)


def _schedule_scalars(opt, opt_cfg: OptConfig, adam: AdamW, gate):
    """(P, 4) [lr, 1-b1^t, 1-b2^t, gate] for the step after ``opt["step"]``;
    the step counter advances for gated partitions too."""
    scalars = schedule_table(opt["step"], opt_cfg, adam, 1)[0]
    scalars[:, 3] = gate
    return opt["step"] + 1, scalars


def _rebuild(opt, step, new_p, new_m, new_v, new_mw, n_hidden):
    new_params = _unpack(new_p, n_hidden)
    new_opt = {**opt, "step": step, "m": _unpack(new_m, n_hidden),
               "v": _unpack(new_v, n_hidden)}
    if new_mw is not None:
        new_opt["mw"] = _unpack(new_mw, n_hidden)
    return new_params, new_opt


def validate_sampling_brick(mode) -> None:
    """Raise unless ``mode`` is a ``DVNRConfig.sampling_brick`` the JAX
    package accepts ("auto", "pinned" or an int edge >= 0). The brick exists
    to fit a TPU's 16 MiB of VMEM: the CUDA kernel gathers straight from
    device memory through L2, so every valid mode gives the same trajectory
    here."""
    if isinstance(mode, bool) or not isinstance(mode, (int, str)) or \
            (isinstance(mode, str) and mode not in ("auto", "pinned")):
        raise ValueError("sampling_brick must be 'auto', 'pinned' or an int "
                         f"edge, got {mode!r}")
    if isinstance(mode, int) and mode < 0:
        raise ValueError(f"sampling_brick edge must be >= 0, got {mode}")


# --------------------------------------------------------------------------- #
# the kernels' wrappers
# --------------------------------------------------------------------------- #
#: the deterministic route's fixed-point table gradient (``csrc/hash_grid.cuh``:
#: an entry is ``round(value * 2**FX_SHIFT)`` summed in int64; a contribution
#: must keep ``N * |contribution| <= FX_BOUND``, else the partition's flag
#: gets ``FX_OVER``; bit 1 marks a NaN or Inf contribution):
#: :mod:`repro_torch.kernels.fixed_point`, shared with the unfused route


def deterministic() -> bool:
    """True when PyTorch's own switch asks for deterministic algorithms:
    the CUDA train step then takes its deterministic route."""
    return torch.are_deterministic_algorithms_enabled()


@dataclass
class DetGrads:
    """The deterministic route's gradients as the train-step kernel leaves
    them: ``partials`` (P, groups, n_w + 1) f32, each group's dW (win, whid,
    wout flattened) and loss sum in its last column; ``tab_fx`` (P, L, T, F)
    int64 fixed point; ``flags`` (P,) int64 flag bits."""
    partials: torch.Tensor
    tab_fx: torch.Tensor
    flags: torch.Tensor


@functools.lru_cache(maxsize=64)
def _step_shape(P, N, L, F, W, n_hidden, D_out, det):
    """(threads per block, blocks per partition, shared bytes, groups) of
    the train step's launch, from the library (a pure function of ints)."""
    shape = (ctypes.c_longlong * 4)()
    build.check(build.library().repro_train_step_shape(
        P, N, L, F, W, n_hidden, D_out, int(det), ctypes.addressof(shape)),
        "repro_train_step_shape")
    return tuple(int(v) for v in shape)


def det_grads_to_float(det: DetGrads, flat_p, n_hidden: int):
    """``(grads {tab, win, whid, wout} f32, loss_sum (P,) f32)`` from a
    :class:`DetGrads`, with the AdamW kernel's arithmetic: each column of the
    group rows summed in float32 in group order from 0, each fixed-point
    entry through float64 (``q * 2**-47``) rounded once to float32. The
    plain version of that reduction, for holding the route against the
    plain step and the AdamW kernel bit for bit. An H = 1 MLP's dummy hidden
    slab gets zeros."""
    P = flat_p["tab"].shape[0]
    rows = torch.zeros_like(det.partials[:, 0])
    for i in range(det.partials.shape[1]):
        rows = rows + det.partials[:, i]
    grads = {"tab": (det.tab_fx.double() * 2.0 ** -FX_SHIFT).float()
             .view(flat_p["tab"].shape)}
    off = 0
    for k in STATE_KEYS[1:]:
        if k == "whid" and n_hidden == 1:
            grads[k] = torch.zeros(flat_p[k].shape, dtype=torch.float32,
                                   device=rows.device)
            continue
        n = flat_p[k][0].numel()
        grads[k] = rows[:, off:off + n].reshape(flat_p[k].shape)
        off += n
    return grads, rows[:, -1]


def _grad_buffers(flat_p, device):
    """One zeroed f32 buffer (one memset) viewed as the four gradient
    groups plus the (P,) loss sum."""
    P = flat_p["tab"].shape[0]
    sizes = [flat_p[k][0].numel() for k in STATE_KEYS]
    buf = torch.zeros(P * sum(sizes) + P, dtype=torch.float32, device=device)
    grads, off = {}, 0
    for k, n in zip(STATE_KEYS, sizes):
        grads[k] = buf[off:off + P * n].view(flat_p[k].shape)
        off += P * n
    return grads, buf[off:]


def step_launch_plan(flat_p, n_hidden: int, resolutions: Sequence[int]) -> list:
    """The train step's launches at these shapes: ``[(kernel, dynamic shared
    bytes)]``, from ``mlp_tile.cuh``'s ``mlp_pick_tile`` (the largest tile
    of 128, 64 and 32 rows whose weights, their gradients, the row tiles and
    a float a row for the loss fit ``SMEM_LIMIT``); the bytes are None when
    no tile fits. Under :func:`deterministic` the split's fixed-point
    scatter follows, one launch a level (``hash_encoding.ops.
    bwd_launch_plan``, without the conversion)."""
    _, D_in, W = flat_p["win"].shape
    D_out = flat_p["wout"].shape[-1]
    odd = lambda n: n | 1
    n_w = D_in * W + (n_hidden - 1) * W * W + W * D_out
    plan = [("train_step_kernel", None)]
    for tile in (128, 64, 32):
        smem = 4 * (2 * n_w + tile * (odd(D_in) + 2 * n_hidden * odd(W)
                                      + odd(D_out)) + tile)
        if smem <= SMEM_LIMIT:
            plan = [("train_step_kernel", smem)]
            break
    if deterministic():
        plan += bwd_launch_plan(resolutions, flat_p["tab"].shape)[:-1]
    return plan


def train_step_cuda(flat_p, n_hidden: int, resolutions: Sequence[int], *,
                    coords=None, target=None, volumes=None, seeds=None,
                    n_batch: int = 0, n_uniform: int = 0, sigma: float = 0.0,
                    ghost: int = 1, cotangent_out=None):
    """The train-step kernel's wrapper: gradients of the per-partition L1
    loss and the per-partition loss SUM for one batch, from the packed
    params ``flat_p`` on the card, all float32 (the float32 kernel) or all
    bf16 (the bf16 policy's kernel: bf16 compute). The batch is either given
    (``coords`` (P,N,3), ``target`` (P,N,D_out)) or drawn in the kernel
    (``volumes`` (P, nx+2g, ny+2g, nz+2g, C) and ``seeds`` (P,2) words as
    int64, ``n_batch`` rows of which the first ``n_uniform`` uniform).
    Returns ``(grads {tab, win, whid, wout} f32, loss_sum (P,) f32)``, or
    under :func:`deterministic` on the card ``(DetGrads, None)`` (the
    deterministic route, split in two: the kernel writes the feature
    cotangent, and the drawn coordinates, to scratch, then the hash
    backward's fixed-point scatter sums them; :func:`det_grads_to_float`
    gives the former). Given ``cotangent_out`` ((P, N, L*F) f32), the
    feature cotangent is written there and ``grads["tab"]`` (``tab_fx``)
    stays zero: the first launch of the two-launch split that
    ``hash_encode_bwd_cuda`` completes (a yardstick of the fused scatter).

    CPU tensors take the plain version (:func:`ref.train_step_grads_ref`,
    drawing the batch with the plain sampler); CUDA tensors launch
    ``repro_train_step`` or raise."""
    with build.kernel_region("train_step", flat_p["tab"],
                             plan=lambda: step_launch_plan(flat_p, n_hidden,
                                                           resolutions)):
        sampling = volumes is not None
        dev = flat_p["tab"].device
        if dev.type == "cpu":
            if sampling:
                coords = batch_coords(seeds, n_batch, n_uniform, sigma)
                target = sample_trilinear_batched(volumes, coords, ghost)
            return _ref.train_step_grads_ref(flat_p, n_hidden, resolutions,
                                             coords, target,
                                             cotangent_out=cotangent_out)
        det = deterministic()
        mode = 0 if not det else (2 if cotangent_out is not None else 1)
        out = _launch_step(flat_p, n_hidden, resolutions, coords, target, volumes,
                           seeds, n_batch, n_uniform, sigma, ghost, cotangent_out,
                           mode)
        dtype = flat_p["tab"].dtype
        train_step_cuda.launches += 1
        train_step_cuda.bf16_launches += int(dtype == torch.bfloat16)
        train_step_cuda.det_launches += int(det)
        return out


def train_step_det_with(flat_p, n_hidden: int, resolutions: Sequence[int], *,
                        design: str = "split", clocks=None, **batch):
    """The deterministic route on the card, for measurement (no count):
    ``design`` "split" (the route: the kernel, then the fixed-point
    scatter) or "fused" (its yardstick, the design before the split: the
    adds inside the step, every level direct; W = 16, F = 4 only). Given
    ``clocks`` ((4,) int64 zeros on the card; "fused", float32, sampling
    only), the clocked instantiation adds each warp's cycles of the scatter
    at the dense levels, at the hashed levels and of the rest of the step,
    then its lifetime in ns. Returns ``(DetGrads, None)``."""
    if design not in ("split", "fused") or (clocks is not None and design != "fused"):
        raise ValueError(f"design 'split' or 'fused' (clocks: 'fused' only), got "
                         f"{design!r}")
    if flat_p["tab"].device.type != "cuda":
        raise ValueError("train_step_det_with runs on the card")
    mode = 1 if design == "split" else (3 if clocks is None else 4)
    kw = dict(coords=None, target=None, volumes=None, seeds=None, n_batch=0,
              n_uniform=0, sigma=0.0, ghost=1)
    kw.update(batch)
    return _launch_step(flat_p, n_hidden, resolutions, kw["coords"], kw["target"],
                        kw["volumes"], kw["seeds"], kw["n_batch"], kw["n_uniform"],
                        kw["sigma"], kw["ghost"], None, mode, clocks)


def _launch_step(flat_p, n_hidden, resolutions, coords, target, volumes, seeds,
                 n_batch, n_uniform, sigma, ghost, cotangent_out, mode, clocks=None):
    """One ``repro_train_step`` call on the card (the checks, the outputs,
    the launch); ``mode`` is its ``det``: 0 the default route, 1 the
    deterministic split, 2 the split's kernel writing ``cotangent_out``
    only, 3 the route's fused yardstick, 4 the same clocked."""
    sampling = volumes is not None
    dev = flat_p["tab"].device
    P, L, T, F = flat_p["tab"].shape
    _, D_in, W = flat_p["win"].shape
    D_out = flat_p["wout"].shape[-1]
    if dev.type != "cuda":
        raise ValueError("train_step_cuda: the state must lie on a CUDA device")
    dtype = flat_p["tab"].dtype
    if dtype not in (torch.float32, torch.bfloat16) or \
            any(flat_p[k].dtype != dtype for k in STATE_KEYS):
        raise TypeError("train_step_cuda: the packed params must share one "
                        "dtype, float32 or bfloat16, got "
                        f"{[flat_p[k].dtype for k in STATE_KEYS]}")
    if D_in != L * F or W not in KERNEL_WIDTHS or F not in (1, 2, 4, 8) or \
            T >= 2**31 or len(resolutions) != L or D_out > 4:
        raise ValueError(f"unsupported shapes: tab {tuple(flat_p['tab'].shape)}, "
                         f"win {tuple(flat_p['win'].shape)}, D_out {D_out} "
                         f"(W in {KERNEL_WIDTHS}, F in 1/2/4/8, D_out <= 4)")
    state = [flat_p[k].contiguous() for k in STATE_KEYS]
    if state[0].data_ptr() % 16:
        raise ValueError("train_step_cuda: the tables must start on a 16-byte "
                         "boundary (the kernel's vector loads)")
    if sampling:
        if volumes.ndim != 5 or volumes.shape[0] != P or \
                volumes.shape[4] != D_out or tuple(seeds.shape) != (P, 2):
            raise ValueError(f"volumes (P,nx,ny,nz,{D_out}) and seeds (P,2) "
                             f"expected, got {tuple(volumes.shape)}, "
                             f"{tuple(seeds.shape)}")
        if volumes.dtype != torch.float32:
            raise TypeError(f"volumes must be float32, got {volumes.dtype}")
        batch = [None, None, volumes.contiguous(),
                 seeds.to(device=dev, dtype=torch.int64).contiguous()]
        N = int(n_batch)
        nx, ny, nz = (int(d) for d in volumes.shape[1:4])
    else:
        N = coords.shape[1]
        if tuple(coords.shape) != (P, N, 3) or \
                tuple(target.shape) != (P, N, D_out):
            raise ValueError(f"coords (P,N,3) and target (P,N,{D_out}) "
                             f"expected, got {tuple(coords.shape)}, "
                             f"{tuple(target.shape)}")
        batch = [coords.float().contiguous(), target.float().contiguous(),
                 None, None]
        nx = ny = nz = 0
    if cotangent_out is not None and (
            tuple(cotangent_out.shape) != (P, N, L * F) or
            cotangent_out.dtype != torch.float32 or cotangent_out.device != dev
            or not cotangent_out.is_contiguous()):
        raise ValueError(f"cotangent_out must be a contiguous ({P}, {N}, "
                         f"{L * F}) float32 tensor on {dev}")
    if mode >= 3 and (W != 16 or F != 4):
        raise ValueError("the deterministic route's fused yardstick is built at "
                         f"W = 16, F = 4 only, got W = {W}, F = {F}")
    res_h = levels_arg(resolutions)
    ptr = lambda t: None if t is None else t.data_ptr()
    g_coords = clk = None
    if mode:
        if N >= 2**40:
            raise ValueError("the deterministic route's fixed-point bound "
                             f"needs N < 2^40, got {N}")
        groups = _step_shape(P, N, L, F, W, n_hidden, D_out, True)[3]
        n_w = sum(flat_p[k][0].numel() for k in ("win", "wout")) + \
            (flat_p["whid"][0].numel() if n_hidden > 1 else 0)
        fx = torch.zeros(P * L * T * F + P, dtype=torch.int64, device=dev)
        out = DetGrads(torch.empty((P, groups, n_w + 1), dtype=torch.float32,
                                   device=dev),
                       fx[:P * L * T * F].view(P, L, T, F), fx[P * L * T * F:])
        g_feat = cotangent_out
        if mode == 1:   # the split's scratch: the cotangent, the drawn coords
            g_feat = torch.empty((P, N, L * F), dtype=torch.float32, device=dev)
            if sampling:
                g_coords = torch.empty((P, N, 3), dtype=torch.float32, device=dev)
        if mode == 4:
            if clocks is None or clocks.dtype != torch.int64 or \
                    clocks.device != dev or clocks.numel() < 4:
                raise ValueError("clocks must be 4 int64 on the card")
            clk = clocks
        outs = [None] * 5 + [ptr(g_feat), out.tab_fx.data_ptr(),
                             out.partials.data_ptr(), out.flags.data_ptr()]
    else:
        grads, loss_sum = _grad_buffers(flat_p, dev)
        outs = [grads[k].data_ptr() for k in STATE_KEYS] + \
            [loss_sum.data_ptr(), ptr(cotangent_out), None, None, None]
    lib = build.library()
    err = lib.repro_train_step(
        *(ptr(t) for t in batch), *(t.data_ptr() for t in state), *outs,
        ptr(g_coords), ptr(clk), ctypes.addressof(res_h), P, N, L, T, F, W,
        n_hidden, flat_p["whid"].shape[1], D_out, nx, ny, nz, int(ghost),
        int(n_uniform), float(sigma), int(sampling),
        int(dtype == torch.bfloat16), int(mode),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "repro_train_step")
    return (out, None) if mode else (grads, loss_sum)


#: launches of the kernel, of its bf16 instantiation and of its
#: deterministic route among them
train_step_cuda.launches = train_step_cuda.bf16_launches = 0
train_step_cuda.det_launches = 0


def adamw_apply_cuda(flat_p, flat_m, flat_v, grads, scalars, loss_sum, *,
                     n_valid: int, beta1: float, beta2: float, eps: float,
                     weight_decay: float, n_hidden: int,
                     flat_mw=None, overflow=None) -> torch.Tensor:
    """The AdamW kernel's wrapper: updates params and moments IN PLACE from
    the f32 ``grads`` with the (P, 4) ``[lr, 1-b1^t, 1-b2^t, gate]``
    ``scalars`` and returns the (P,) mean loss ``loss_sum / n_valid``.
    Params are float32 and their own master, or bf16 with the float32
    master ``flat_mw`` (updated in place, the bf16 params re-derived from
    it); moments float32. ``grads`` may be the deterministic route's
    :class:`DetGrads` (``loss_sum`` None): the kernel sums its group rows in
    order and converts the fixed-point table gradient, a flagged partition
    gets NaN gradients and loss, and its flag bits are ORed into
    ``overflow`` ((P,) int64 on the card) when given.

    CPU tensors take the plain version (:func:`ref.adamw_apply_ref`);
    CUDA tensors launch ``repro_adamw_apply`` (``csrc/adamw.cu``) or
    raise."""
    with build.kernel_region("adamw_apply",
                             plan=lambda: [("adamw_kernel", 0)]):
        dev = flat_p["tab"].device
        if dev.type == "cpu":
            _ref.adamw_apply_ref(flat_p, flat_m, flat_v, flat_mw, grads, scalars,
                                 beta1=beta1, beta2=beta2, eps=eps,
                                 weight_decay=weight_decay, n_hidden=n_hidden)
            return loss_sum / float(n_valid)
        master = flat_mw is not None
        det = grads if isinstance(grads, DetGrads) else None
        p_dtype = torch.bfloat16 if master else torch.float32
        groups = []
        for k in STATE_KEYS:
            # the deterministic route has no float32 gradient: its moments stand in
            # for the checks
            ts = (flat_p[k], flat_m[k], flat_v[k],
                  flat_m[k] if det is not None else grads[k]) \
                + ((flat_mw[k],) if master else ())
            if any(t.device != dev or not t.is_contiguous() for t in ts) or \
                    ts[0].dtype != p_dtype or \
                    any(t.dtype != torch.float32 for t in ts[1:]):
                raise TypeError(
                    f"repro_adamw_apply takes contiguous {k} params, moments, "
                    "gradients (and master) on one CUDA device: float32 params "
                    "without a master, or bf16 params with a float32 master; "
                    "moments, gradients and master float32")
            n = 0 if (k == "whid" and n_hidden == 1) else flat_p[k][0].numel()
            groups += [t.data_ptr() for t in ts[:3]] \
                + [None if det is not None else ts[3].data_ptr(),
                   ts[4].data_ptr() if master else None, n]
        P = flat_p["tab"].shape[0]
        scalars = scalars.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(scalars.shape) != (P, 4):
            raise ValueError(f"scalars must be (P, 4), got {tuple(scalars.shape)}")
        loss = torch.empty(P, dtype=torch.float32, device=dev)
        if det is not None:
            if overflow is not None and (overflow.dtype != torch.int64 or
                                         tuple(overflow.shape) != (P,) or
                                         overflow.device != dev):
                raise ValueError(f"overflow must be a ({P},) int64 tensor on {dev}")
            det_args = [det.partials.data_ptr(), det.partials.shape[1],
                        det.partials.shape[2], det.tab_fx.data_ptr(),
                        det.flags.data_ptr(),
                        None if overflow is None else overflow.data_ptr()]
        else:
            det_args = [None, 0, 0, None, None, None]
        lib = build.library()
        err = lib.repro_adamw_apply(
            *groups, scalars.data_ptr(),
            None if loss_sum is None else loss_sum.data_ptr(), loss.data_ptr(), P,
            float(n_valid), beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
            weight_decay, int(master), *det_args,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "repro_adamw_apply")
        adamw_apply_cuda.launches += 1
        adamw_apply_cuda.bf16_launches += int(master)
        return loss


#: launches of the kernel, and of its master-weight (bf16 policy) variant
adamw_apply_cuda.launches = adamw_apply_cuda.bf16_launches = 0


# --------------------------------------------------------------------------- #
# the entry points
# --------------------------------------------------------------------------- #
def _fused_cuda(params, opt, opt_cfg, adam, gate, scalars, n_valid,
                compute_dtype, overflow=None, **batch):
    flat_p, flat_m, flat_v, flat_mw, n_hidden = _pack_state(params, opt)
    if scalars is None:
        step, scalars = _schedule_scalars(opt, opt_cfg, adam, gate)
    else:
        step = opt["step"] + 1
    # the kernel runs in the compute dtype: params stored in another dtype
    # are cast to it, as the plain version casts them (a no-op otherwise)
    flat_c = flat_p if compute_dtype is None else \
        {k: v.to(compute_dtype) for k, v in flat_p.items()}
    grads, loss_sum = train_step_cuda(flat_c, n_hidden, **batch)
    loss = adamw_apply_cuda(flat_p, flat_m, flat_v, grads, scalars, loss_sum,
                            n_valid=n_valid, beta1=opt_cfg.beta1,
                            beta2=opt_cfg.beta2, eps=opt_cfg.eps,
                            weight_decay=opt_cfg.weight_decay,
                            n_hidden=n_hidden, flat_mw=flat_mw,
                            overflow=overflow)
    new_params, new_opt = _rebuild(opt, step, flat_p, flat_m, flat_v, flat_mw,
                                   n_hidden)
    return new_params, new_opt, loss


def _gate_from(scalars, gate):
    return scalars[:, 3] if scalars is not None else gate


def fused_train_step(params, opt, coords, target, gate, *,
                     resolutions: Sequence[int], opt_cfg: OptConfig,
                     impl: backends.BackendLike = "ref", compute_dtype=None,
                     scalars=None, overflow=None):
    """One fused L1 train step over the stacked partition axis.

    params/opt: the (P, ...)-stacked trainer trees (``opt`` from
    ``AdamW.init(params, P)``: step/m/v and, under mixed precision, the f32
    master ``"mw"``); coords (P, N, 3) f32; target (P, N, out_dim) f32;
    gate (P,) f32 (1 = active, 0 = converged: moments still advance).
    ``scalars`` optionally gives the (P, 4) ``[lr, 1-b1^t, 1-b2^t, gate]``
    rows precomputed (:func:`schedule_table`; ``gate`` is then its last
    column). Returns ``(params, opt, loss)``, loss (P,) f32. The ``cuda``
    backend updates the given state in place (see the module notes); under
    :func:`deterministic` it ORs each partition's fixed-point flag bits into
    ``overflow`` ((P,) int64) when given."""
    backend = backends.resolve(impl)
    if not backend.supports("fused_train_step"):
        raise ValueError(f"backend {backend.name!r} does not implement "
                         "fused_train_step")
    adam = AdamW(opt_cfg)
    if not backend.is_cuda:
        return _ref.train_step_ref(params, opt, coords, target,
                                   _gate_from(scalars, gate), resolutions,
                                   adam, backend, compute_dtype)
    cdt = _check_kernel_opt(opt_cfg, backend, compute_dtype)
    return _fused_cuda(params, opt, opt_cfg, adam, gate, scalars,
                       coords.shape[1] * target.shape[2], cdt, overflow,
                       resolutions=resolutions, coords=coords, target=target)


def fused_train_step_sampling(params, opt, volumes, seeds, gate, *,
                              n_batch: int, boundary_lambda: float,
                              sigma: float, ghost: int,
                              resolutions: Sequence[int], opt_cfg: OptConfig,
                              impl: backends.BackendLike = "ref",
                              compute_dtype=None, sampling_brick="auto",
                              scalars=None, overflow=None):
    """One fused train step with the batch SAMPLING inside the op: instead
    of coords/targets it takes the stacked ghost-padded ``volumes``
    (P, nx+2g, ny+2g, nz+2g[, C]) and the (P, 2) per-(step, partition)
    counter ``seeds`` (:func:`repro_torch.core.sampling.step_seeds`). On the
    ``cuda`` backend the draws and the trilinear gather happen in the
    train-step kernel, so no coordinates or targets reach device memory.
    ``sampling_brick`` is validated and changes nothing here (see
    :func:`validate_sampling_brick`). Otherwise as :func:`fused_train_step`."""
    backend = backends.resolve(impl)
    if not backend.supports("fused_sampling"):
        raise ValueError(f"backend {backend.name!r} does not implement "
                         "fused_sampling")
    validate_sampling_brick(sampling_brick)
    adam = AdamW(opt_cfg)
    if not backend.is_cuda:
        return _ref.train_step_sampling_ref(
            params, opt, volumes, seeds, _gate_from(scalars, gate),
            resolutions, adam, backend, n_batch=n_batch,
            boundary_lambda=boundary_lambda, sigma=sigma, ghost=ghost,
            compute_dtype=compute_dtype)
    cdt = _check_kernel_opt(opt_cfg, backend, compute_dtype)
    vols_c = volumes if volumes.ndim == 5 else volumes[..., None]
    return _fused_cuda(params, opt, opt_cfg, adam, gate, scalars,
                       int(n_batch) * vols_c.shape[4], cdt, overflow,
                       resolutions=resolutions, volumes=vols_c, seeds=seeds,
                       n_batch=int(n_batch),
                       n_uniform=int(n_batch) - n_boundary(int(n_batch),
                                                           boundary_lambda),
                       sigma=float(sigma), ghost=int(ghost))

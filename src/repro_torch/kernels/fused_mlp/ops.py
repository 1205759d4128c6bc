"""Fused MLP: backend dispatch, the autograd function, and the CUDA
kernels' wrappers.

``fused_mlp`` is the single-model op (x (N,D_in), weights
``[w_in, hidden..., w_out]``); ``fused_mlp_batched`` is the hot-path form:
rows (B,N,D_in) against partition-stacked weights, one launch for every
partition and client. Both are differentiable in x and the weights: the
backward recomputes the activations and runs the layer stack in reverse,
the plain VJP on the ``ref`` backend and ``repro_fused_mlp_bwd``
(``csrc/fused_mlp.cu``) on the card.
"""
from __future__ import annotations

import torch

from repro_torch import backends
from repro_torch.kernels import build
from repro_torch.kernels.fused_mlp import ref as _ref

#: hidden widths the kernel is instantiated for (a layer's sums live in
#: registers, W of them per thread)
KERNEL_WIDTHS = (16, 32, 64)


def _stack(weights):
    """[w_in, h1..h_{H-1}, w_out] -> (w_in, w_hid, w_out, n_hidden), with
    ``w_hid`` (..., max(H-1,1), W, W): an all-zero dummy slab when H == 1,
    which the kernel's layer loop (n_hidden) never reads. Works on single
    (2-D) and partition-stacked (3-D) weights alike."""
    w_in, *hid, w_out = weights
    n_hidden = len(hid) + 1
    W = w_in.shape[-1]
    if hid:
        w_hid = torch.stack(hid, dim=-3)
    else:
        w_hid = torch.zeros((*w_in.shape[:-2], 1, W, W), dtype=w_in.dtype,
                            device=w_in.device)
    return w_in, w_hid, w_out, n_hidden


def fused_mlp_cuda(x: torch.Tensor, weights, part) -> torch.Tensor:
    """The kernel's wrapper: x (B,N,D_in), partition-stacked weights
    ``[w_in (P,D_in,W), hidden (P,W,W)..., w_out (P,W,D_out)]`` in x's dtype,
    ``part`` (B,) -> (B,N,D_out).

    CPU tensors take the plain version; CUDA tensors launch
    ``repro_fused_mlp_fwd`` (``csrc/fused_mlp.cu``) or raise."""
    if x.device.type == "cpu":
        return _ref.fused_mlp_batched_ref(x, weights, torch.as_tensor(part))
    w_in, w_hid, w_out, n_hidden = _stack(weights)
    B, N, D_in = x.shape
    P, D_in_w, W = w_in.shape
    D_out = w_out.shape[-1]
    if x.device.type != "cuda" or any(w.device != x.device for w in weights):
        raise ValueError("fused_mlp_cuda: x and weights must lie on one CUDA "
                         "device")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            any(w.dtype != x.dtype for w in weights):
        raise TypeError("fused_mlp_cuda: x and weights must share one dtype, "
                        f"float32 or bfloat16 (x is {x.dtype})")
    if D_in_w != D_in or W not in KERNEL_WIDTHS or B > 65535 or \
            tuple(w_out.shape[:2]) != (P, W):
        raise ValueError(f"unsupported shapes: x {tuple(x.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)} "
                         f"(W in {KERNEL_WIDTHS}, B <= 65535)")
    x, w_in, w_hid, w_out = (t.contiguous() for t in (x, w_in, w_hid, w_out))
    part_d = build.part_tensor(part, B, P, x.device)
    out = torch.empty((B, N, D_out), dtype=x.dtype, device=x.device)
    lib = build.library()
    err = lib.repro_fused_mlp_fwd(
        x.data_ptr(), w_in.data_ptr(), w_hid.data_ptr(), w_out.data_ptr(),
        part_d.data_ptr(), out.data_ptr(), B, N, D_in, W, n_hidden,
        w_hid.shape[1], D_out, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "repro_fused_mlp_fwd")
    fused_mlp_cuda.launches += 1
    return out


fused_mlp_cuda.launches = 0


def fused_mlp_bwd_cuda(x: torch.Tensor, weights, g: torch.Tensor, part):
    """The backward kernel's wrapper: x (B,N,D_in) and partition-stacked
    weights as for :func:`fused_mlp_cuda`, cotangent ``g`` (B,N,D_out), all
    float32 or all bfloat16 -> ``(dx (B,N,D_in) in x's dtype, [dW (P, ...)
    ...] float32)``, every dW the float32 sum over the rows of its
    partition.

    CPU tensors take the plain version; CUDA tensors launch
    ``repro_fused_mlp_bwd`` (``csrc/fused_mlp.cu``: activations recomputed
    on chip, each block's dW reduced in shared memory, one atomic add per
    weight per block into zeroed f32 gradients; bf16 operands rounded where
    the plain version rounds them) or raise."""
    if x.device.type == "cpu":
        return _ref.fused_mlp_batched_bwd_ref(x, weights, g, torch.as_tensor(part))
    w_in, w_hid, w_out, n_hidden = _stack(weights)
    B, N, D_in = x.shape
    P, D_in_w, W = w_in.shape
    D_out = w_out.shape[-1]
    if x.device.type != "cuda" or g.device != x.device or \
            any(w.device != x.device for w in weights):
        raise ValueError("fused_mlp_bwd_cuda: x, g and weights must lie on "
                         "one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != x.dtype for t in (g, *weights)):
        raise TypeError("fused_mlp_bwd_cuda: x, g and weights must share one "
                        f"dtype, float32 or bfloat16 (x is {x.dtype})")
    if D_in_w != D_in or W not in KERNEL_WIDTHS or B > 65535 or \
            tuple(w_out.shape[:2]) != (P, W) or tuple(g.shape) != (B, N, D_out):
        raise ValueError(f"unsupported shapes: x {tuple(x.shape)}, w_in "
                         f"{tuple(w_in.shape)}, w_out {tuple(w_out.shape)}, g "
                         f"{tuple(g.shape)} (W in {KERNEL_WIDTHS}, B <= 65535)")
    x, g, w_in, w_hid, w_out = (t.contiguous() for t in (x, g, w_in, w_hid, w_out))
    part_d = build.part_tensor(part, B, P, x.device)
    dx = torch.empty_like(x)
    dw_in, dw_hid, dw_out = (torch.zeros_like(w, dtype=torch.float32)
                             for w in (w_in, w_hid, w_out))
    lib = build.library()
    err = lib.repro_fused_mlp_bwd(
        x.data_ptr(), w_in.data_ptr(), w_hid.data_ptr(), w_out.data_ptr(),
        g.data_ptr(), part_d.data_ptr(), dx.data_ptr(), dw_in.data_ptr(),
        dw_hid.data_ptr(), dw_out.data_ptr(), B, N, D_in, W, n_hidden,
        w_hid.shape[1], D_out, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "repro_fused_mlp_bwd")
    fused_mlp_bwd_cuda.launches += 1
    fused_mlp_bwd_cuda.bf16_launches += int(x.dtype == torch.bfloat16)
    return dx, [dw_in] + [dw_hid[:, k] for k in range(n_hidden - 1)] + [dw_out]


#: launches of the kernel, and of its bf16 instantiation among them
fused_mlp_bwd_cuda.launches = fused_mlp_bwd_cuda.bf16_launches = 0


class _FusedMLPBatched(torch.autograd.Function):
    """Forward through the backend's MLP; backward the recomputing VJP (the
    CUDA backward kernel on the ``cuda`` backend)."""

    @staticmethod
    def forward(ctx, x, part, backend, *weights):
        part_t = torch.as_tensor(part, dtype=torch.int64, device="cpu") \
            .reshape(-1)
        ctx.save_for_backward(x, *weights)
        ctx.part, ctx.backend = part_t, backend
        if backend.is_cuda:
            return fused_mlp_cuda(x, list(weights), part_t)
        return _ref.fused_mlp_batched_ref(x, list(weights),
                                          part_t.to(x.device))

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        if ctx.backend.is_cuda:
            dx, dws = fused_mlp_bwd_cuda(x, weights, g, ctx.part)
        else:
            dx, dws = _ref.fused_mlp_batched_bwd_ref(x, weights, g,
                                                     ctx.part.to(x.device))
        return (dx.to(x.dtype), None, None,
                *(d.to(w.dtype) for d, w in zip(dws, weights)))


def _cast(x, weights, backend, compute_dtype):
    if compute_dtype is None:
        return x, list(weights)
    dt = backend.require_dtype(compute_dtype)
    return x.to(dt), [w.to(dt) for w in weights]


def fused_mlp_batched(x, weights, part, impl: backends.BackendLike = "ref", *,
                      compute_dtype=None):
    """x (B,N,D_in); partition-stacked weights; part (B,) -> (B,N,D_out),
    differentiable in x and the weights."""
    backend = backends.resolve(impl)
    x, weights = _cast(x, weights, backend, compute_dtype)
    return _FusedMLPBatched.apply(x, part, backend, *weights)


def fused_mlp(x, weights, impl: backends.BackendLike = "ref", *,
              compute_dtype=None):
    """x (N, D_in); weights [w_in, hidden..., w_out] -> (N, D_out) in the
    input dtype (or ``compute_dtype``'s: activations and weights are cast
    first). Differentiable in x and the weights."""
    return fused_mlp_batched(x[None], [w[None] for w in weights], [0], impl,
                             compute_dtype=compute_dtype)[0]

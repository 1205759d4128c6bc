"""Plain PyTorch fused tiny-MLP (tiny-cuda-nn analogue).

The port of ``repro.kernels.fused_mlp.ref``: a bias-free ReLU MLP
x (N, D_in) -> (D_in, W) -> (W, W) x (H-1) -> (W, D_out), weights laid out
``(d_in, d_out)`` and used as ``x @ w``. Products accumulate in float32; a
narrower input dtype (bf16) rounds each layer's output to that dtype, as the
JAX reference's per-matmul bf16 outputs do, so bf16 in gives bf16 out.
"""
from __future__ import annotations

import torch


def _layers(h: torch.Tensor, weights, dtype: torch.dtype) -> torch.Tensor:
    for w in weights[:-1]:
        h = torch.relu(torch.matmul(h, w.float())).to(dtype).float()
    return torch.matmul(h, weights[-1].float()).to(dtype)


def fused_mlp_batched_ref(x: torch.Tensor, weights, part: torch.Tensor) -> torch.Tensor:
    """x (B,N,D_in) against partition-stacked weights [(P,D_in,W), (P,W,W)...,
    (P,W,D_out)]; row ``b`` uses partition ``part[b]`` -> (B,N,D_out)."""
    idx = part.to(device=x.device, dtype=torch.int64)
    return _layers(x.float(), [w[idx] for w in weights], x.dtype)


def fused_mlp_batched_bwd_ref(x: torch.Tensor, weights, g: torch.Tensor,
                              part: torch.Tensor):
    """The plain backward of :func:`fused_mlp_batched_ref`: the VJP of the
    forward at cotangent ``g`` (B,N,D_out) -> ``(dx, [dW...])``, each dW
    summed over the rows of its partition ((P, ...) like the weights). The
    activations are recomputed, as the JAX package's backward kernel does.
    dx comes in x's dtype (a bf16 dx is rounded once from its float32 sum);
    each dW is the float32 sum, unrounded, whatever the weights' dtype (the
    autograd function rounds it once to the weights' dtype). Under bf16 the
    autograd of the forward rounds each layer's delta to bf16 where it
    crosses a bf16 activation: the CUDA backward's rounding points."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        ws = [w.detach().to(torch.promote_types(w.dtype, torch.float32))
              .requires_grad_(True) for w in weights]
        out = fused_mlp_batched_ref(xs, ws, part)
        grads = torch.autograd.grad(out, [xs, *ws], g)
    return grads[0], list(grads[1:])

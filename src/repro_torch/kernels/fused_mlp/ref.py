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


def fused_mlp_ref(x: torch.Tensor, weights) -> torch.Tensor:
    """x (..., D_in); weights [w_in, hidden..., w_out] -> (..., D_out)."""
    return _layers(x.float(), weights, x.dtype)


def fused_mlp_batched_ref(x: torch.Tensor, weights, part: torch.Tensor) -> torch.Tensor:
    """x (B,N,D_in) against partition-stacked weights [(P,D_in,W), (P,W,W)...,
    (P,W,D_out)]; row ``b`` uses partition ``part[b]`` -> (B,N,D_out)."""
    idx = part.to(device=x.device, dtype=torch.int64)
    return _layers(x.float(), [w[idx] for w in weights], x.dtype)

"""Reconstruction-quality metrics: the port of ``repro.core.metrics``
(PSNR, NRMSE; SSIM comes with the compression slice).

PSNR follows the paper: data normalized to [0,1], aggregated across
partitions by averaging the MSE first (V-B). Reductions run in float32.
"""
from __future__ import annotations

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a.float() - b.float()))


def psnr(a, b, data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse(a, b), min=1e-20))


def psnr_from_mses(mses, data_range: float = 1.0) -> torch.Tensor:
    """Paper V-B: PSNR computed from the average MSE across partitions."""
    m = torch.mean(torch.as_tensor(mses, dtype=torch.float32))
    return 10.0 * torch.log10(data_range**2 / torch.clamp(m, min=1e-20))


def nrmse(a, b) -> torch.Tensor:
    rng = torch.clamp(b.max() - b.min(), min=1e-12)
    return torch.sqrt(mse(a, b)) / rng

"""Reconstruction-quality metrics: the port of ``repro.core.metrics``
(PSNR, SSIM (3D windowed and image-space), DSSIM, NRMSE).

PSNR follows the paper: data normalized to [0,1], aggregated across
partitions by averaging the MSE first (V-B). SSIM uses a 7^3 uniform window
over the valid region; DSSIM = (1-SSIM)/2 (Baker et al. floating-point
variant). Reductions run in float32; the window means are PyTorch's
average pooling, which sums in another order than XLA's ``reduce_window``
(the two agree to ~1e-7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


def _uniform_filter3d(x: torch.Tensor, w: int) -> torch.Tensor:
    """Mean filter with a w^3 window (valid region)."""
    return F.avg_pool3d(x[None, None], w, stride=1)[0, 0]


def ssim3d(a, b, data_range: float = 1.0, win: int = 7) -> torch.Tensor:
    a = a.float()
    b = b.float()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _uniform_filter3d(a, win)
    mu_b = _uniform_filter3d(b, win)
    ex_aa = _uniform_filter3d(a * a, win)
    ex_bb = _uniform_filter3d(b * b, win)
    ex_ab = _uniform_filter3d(a * b, win)
    va = ex_aa - mu_a**2
    vb = ex_bb - mu_b**2
    cov = ex_ab - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    return torch.mean(num / den)


def dssim(a, b, data_range: float = 1.0, win: int = 7) -> torch.Tensor:
    return (1.0 - ssim3d(a, b, data_range, win)) / 2.0


def _uniform_filter2d(x: torch.Tensor, w: int) -> torch.Tensor:
    """Mean filter with a w^2 window over the leading two dims of (H,W) or
    (H,W,C)."""
    if x.ndim == 2:
        return F.avg_pool2d(x[None, None], w, stride=1)[0, 0]
    return F.avg_pool2d(x.permute(2, 0, 1)[None], w, stride=1)[0].permute(1, 2, 0)


def ssim2d(a, b, data_range: float = 1.0, win: int = 7) -> torch.Tensor:
    """Image-space SSIM (paper Fig. 8/9 rendering comparisons). a, b: (H,W)
    or (H,W,C) in [0, data_range]; channels averaged."""
    a = a.float()
    b = b.float()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _uniform_filter2d(a, win)
    mu_b = _uniform_filter2d(b, win)
    ex_aa = _uniform_filter2d(a * a, win)
    ex_bb = _uniform_filter2d(b * b, win)
    ex_ab = _uniform_filter2d(a * b, win)
    va = ex_aa - mu_a**2
    vb = ex_bb - mu_b**2
    cov = ex_ab - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    return torch.mean(num / den)

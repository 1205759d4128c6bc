"""Compositing: backend dispatch and the CUDA kernel's wrapper (inference
only, as in the paper: no backward pass)."""
from __future__ import annotations

import math

import torch

from repro_torch import backends
from repro_torch.kernels import build
from repro_torch.kernels.composite.ref import composite_ref


def composite_cuda(rgba: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: rgba (..., S, 4) f32/bf16 -> (..., 4); every
    leading axis (rays, partitions, clients) goes into one launch.

    CPU tensors take the plain version; CUDA tensors launch
    ``repro_composite`` (``csrc/composite.cu``) or raise."""
    with build.kernel_region("composite", rgba,
                             plan=lambda: [("composite_kernel", 0)]):
        if rgba.device.type == "cpu":
            return composite_ref(rgba)
        if rgba.device.type != "cuda":
            raise ValueError("composite_cuda: rgba must lie on a CUDA device")
        if rgba.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"rgba must be float32 or bfloat16, got {rgba.dtype}")
        *lead, S, four = rgba.shape
        if four != 4:
            raise ValueError(f"rgba must be (..., S, 4), got {tuple(rgba.shape)}")
        rgba = rgba.contiguous()
        R = math.prod(lead)
        out = torch.empty((*lead, 4), dtype=rgba.dtype, device=rgba.device)
        lib = build.library()
        err = lib.repro_composite(rgba.data_ptr(), out.data_ptr(), R, S,
                                  int(rgba.dtype == torch.bfloat16),
                                  torch.cuda.current_stream(rgba.device).cuda_stream)
        build.check(err, "repro_composite")
        composite_cuda.launches += 1
        return out


composite_cuda.launches = 0


def composite(rgba, impl: backends.BackendLike = "ref", *, compute_dtype=None):
    """rgba (..., S, 4) front-to-back -> (..., 4) in the input dtype;
    ``compute_dtype`` casts the sample buffer first."""
    b = backends.resolve(impl)
    if compute_dtype is not None:
        rgba = rgba.to(b.require_dtype(compute_dtype))
    if b.is_cuda:
        return composite_cuda(rgba)
    return composite_ref(rgba)

"""Flash attention: backend dispatch, the autograd function and the CUDA
kernel's wrapper.

``flash_attention`` takes the model layout (B,S,H,dh) on every backend; the
kernel reads that layout in place (no transposes). The backward recomputes
through the plain version, as the JAX package's custom VJP does: there is
no backward kernel, and no S x S residual is kept between the passes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import backends
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: head dims the kernel is instantiated for (SMOKE configs 16; qwen2 64;
#: danube 80; llama / olmo 128)
KERNEL_HEAD_DIMS = (16, 32, 64, 80, 128)
#: keys per tile of the bf16 kernel, which rounds p to bf16 per tile:
#: ``attention_tiled_ref(..., block_k=KERNEL_BLOCK_K)`` repeats it
KERNEL_BLOCK_K = 128
#: query rows per block of the bf16 kernel
TC_BLOCK_Q = 128


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """The kernel's wrapper: q (B,Sq,Hq,dh), k/v (B,Sk,Hkv,dh), one dtype
    (float32 or bfloat16) -> (B,Sq,Hq,dh) in that dtype. Query positions are
    right-aligned to the keys (``(Sk - Sq) + i``). Causal with Sq > Sk
    raises: its first rows have no key to attend to, where the kernel
    writes 0 and the plain version a uniform average.

    CPU tensors take the plain version; CUDA tensors launch
    ``repro_flash_attention`` (``csrc/flash_attention.cu``) or raise. The
    dtype picks the kernel: bfloat16 runs on the tensor cores (wgmma, TMA;
    p rounded to bf16 before the PV product, as the plain version rounds
    its probabilities), float32 on the CUDA cores (a TF32 product would
    break float32's 2e-5 limit)."""
    with build.kernel_region("flash_attention", q, k, v, plan=lambda: [(
            "flash_attention_kernel_bf16_wgmma" if q.dtype == torch.bfloat16
            else "flash_attention_kernel", None)]):
        if causal and q.dim() == 4 and k.dim() == 4 and q.shape[1] > k.shape[1]:
            raise ValueError(f"flash_attention_cuda: causal with Sq={q.shape[1]} > "
                             f"Sk={k.shape[1]} leaves query rows without keys")
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal, window=window)
        if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v must lie on one CUDA "
                             "device")
        if q.dtype not in (torch.float32, torch.bfloat16) or \
                k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError("flash_attention_cuda: q, k, v must share one dtype, "
                            f"float32 or bfloat16 (q is {q.dtype})")
        if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
            raise ValueError(f"flash_attention_cuda: q (B,Sq,Hq,dh), k/v (B,Sk,Hkv,dh) "
                             f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        B, Sq, Hq, dh = q.shape
        Bk, Sk, Hkv, dhk = k.shape
        if Bk != B or dhk != dh or Hkv == 0 or Hq % Hkv:
            raise ValueError(f"flash_attention_cuda: incompatible q {tuple(q.shape)} "
                             f"and k/v {tuple(k.shape)}")
        if dh not in KERNEL_HEAD_DIMS:
            raise ValueError(f"flash_attention_cuda: head dim {dh} not in "
                             f"{KERNEL_HEAD_DIMS}")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q)
        if out.numel() == 0:
            return out
        lib = build.library()
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, Hq, Hkv, dh, int(causal), int(window is not None),
            int(window or 0), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(err, "repro_flash_attention")
        flash_attention_cuda.launches += 1
        return out


flash_attention_cuda.launches = 0


def flash_attention_bf16_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True, window: Optional[int] = None):
    """The bf16 kernel's check instantiation, for the on-card checks only (no
    path calls it, and it counts no launch): bf16 CUDA q, k, v as
    ``flash_attention_cuda`` takes them -> (out, p), out as the wrapper's
    and p (rows, Sk) float32, the kernel's p before its bf16 rounding for
    batch 0, q head 0 and the rows of the last 128-row q tile (``rows`` =
    Sq - 128 * (ceil(Sq / 128) - 1)), NaN where the kernel skips a tile."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 or \
            k.dtype != q.dtype or v.dtype != q.dtype or dh not in KERNEL_HEAD_DIMS:
        raise ValueError("flash_attention_bf16_p takes bf16 CUDA tensors with a "
                         f"head dim in {KERNEL_HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    p = torch.full((TC_BLOCK_Q, Sk), float("nan"), device=q.device)
    err = build.library().repro_flash_attention_bf16_p(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), p.data_ptr(),
        B, Sq, Sk, Hq, Hkv, dh, int(causal), int(window is not None),
        int(window or 0), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "repro_flash_attention_bf16_p")
    return out, p[:Sq - TC_BLOCK_Q * ((Sq - 1) // TC_BLOCK_Q)]


def _fwd_impl(q, k, v, causal, window, backend):
    if backend.is_cuda:
        return flash_attention_cuda(q, k, v, causal, window)
    return attention_ref(q, k, v, causal=causal, window=window)


class _FlashAttention(torch.autograd.Function):
    """Forward through the backend; backward recomputes the plain version's
    VJP (flash-style recompute, as JAX's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, backend):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _fwd_impl(q, k, v, causal, window, backend)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_ref(q, k, v, causal=ctx.causal, window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    impl: backends.BackendLike = "ref", *,
                    compute_dtype=None):
    """q (B,Sq,Hq,dh); k,v (B,Sk,Hkv,dh) -> (B,Sq,Hq,dh).

    Output carries q's dtype (softmax stays f32 internally — the standard
    mixed-precision attention recipe); ``compute_dtype`` casts q/k/v first."""
    backend = backends.resolve(impl)
    if compute_dtype is not None:
        dt = backend.require_dtype(compute_dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    return _FlashAttention.apply(q, k, v, causal, window, backend)

"""Plain PyTorch flash attention: materialized-scores GQA attention, the
version every CUDA launch is held against and the one CPU tensors take.

Mirrors ``repro.kernels.flash_attention.ref.attention_ref``: scores in
float32 divided by ``sqrt(dh)``, ``-1e30`` masking, query positions
right-aligned to the keys (``(Sk - Sq) + i``), softmax in float32 and the
probabilities cast to q's dtype before the PV product."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,Hq,dh); k,v (B,Sk,Hkv,dh) -> (B,Sq,Hq,dh)."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(dh)
    q_pos = (Sk - Sq) + torch.arange(Sq, device=q.device)[:, None]  # right-aligned
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, dh)


def _tiled(q, k, v, causal, window, block_k, p_weights, keep_p=None):
    """The kernels' online-softmax loop: sum_i p_weights(p)_i v_i / l over
    ``block_k``-key tiles, p in float32 as the bf16 kernel computes it,
    l from the float32 p; (B,Sq,Hq,dh) float32. ``keep_p``, where given,
    gets each tile's p (B,Hkv,g,Sq,keys) and the tile's first key."""
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.float().reshape(B, Sq, Hkv, g, dh)
    kf, vf = k.float(), v.float()
    # c = log2(e) / sqrt(dh) in float32; scores stay in raw units (q.k),
    # p = 2^(s c - m c) with s c - m c rounded once (the kernel's FFMA:
    # the float64 product of two float32 values is exact), and a row whose
    # keys so far are all masked (m the sentinel) takes p = 0
    c = torch.tensor(1.4426950408889634, dtype=torch.float32) \
        / torch.tensor(float(dh), dtype=torch.float32).sqrt()
    c = c.to(q.device)
    shift = Sk - Sq
    q_pos = shift + torch.arange(Sq, device=q.device)[:, None]
    k_hi = min(Sk, shift + Sq) if causal else Sk
    k_lo = max(0, shift - window + 1) if window is not None else 0
    m = torch.full((B, Hkv, g, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, g, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, dh), device=q.device)
    for k0 in range((k_lo // block_k) * block_k, k_hi, block_k):
        k1 = min(k0 + block_k, Sk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, k0:k1])
        k_pos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        ms = torch.where(m_new == NEG_INF, 0.0, m_new * c)
        p = torch.exp2((s.double() * c.double() - ms.double()[..., None]).float())
        if keep_p is not None:
            keep_p(p, k0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p_weights(p), vf[:, k0:k1])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dh)


def attention_tiled_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, block_k: int = 64,
                        p_dtype=torch.float32) -> torch.Tensor:
    """The online-softmax schedule of the CUDA kernels, in plain PyTorch:
    q (B,Sq,Hq,dh); k,v (B,Sk,Hkv,dh) -> (B,Sq,Hq,dh) in q's dtype.

    Keys go in ``block_k`` tiles aligned as the kernels align them (from
    ``(k_lo // block_k) * block_k``, ``k_lo`` the window's first live key);
    scores are float32 with the ``-1e30`` sentinel; p = exp(s - m_running),
    computed as the bf16 kernel does (2^(s c - m c), c = log2(e)/sqrt(dh)),
    is cast to ``p_dtype`` before the PV product (the bf16 kernel's rounding
    point with ``torch.bfloat16``) while the row sum l is taken from the
    float32 p; out = acc / max(l, 1e-30). For the tests and the on-card
    checks only: no path calls it."""
    return _tiled(q, k, v, causal, window, block_k,
                  lambda p: p.to(p_dtype).float()).to(q.dtype)


def p_rounding_slack(q, k, v, *, causal: bool = True,
                     window: Optional[int] = None, block_k: int = 64,
                     p_dtype=torch.bfloat16, rel: float = 2.0 ** -16):
    """How far ``attention_tiled_ref(..., p_dtype=p_dtype)`` may move where
    its float32 p lies within a relative ``rel`` of a ``p_dtype`` rounding
    tie: sum_i |round(p_i (1+rel)) - round(p_i (1-rel))| |v_i| / l, float32
    (B,Sq,Hq,dh). Scores summed in another order (a tensor-core product
    against a float32 GEMM) move p by a few float32 ulps, which rounds
    those p to the other neighbour: one ulp of p_dtype each. Zero where no
    p lies that near a tie. The on-card check measures how far the bf16
    kernel's own p lies from this yardstick's (``tiled_probabilities``)
    and fails where that exceeds ``rel``."""
    def flip(p):
        return ((p * (1 + rel)).to(p_dtype).float()
                - (p * (1 - rel)).to(p_dtype).float()).abs()
    return _tiled(q, k, v.abs(), causal, window, block_k, flip)


def tiled_probabilities(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        block_k: int = 64) -> torch.Tensor:
    """The float32 p that ``attention_tiled_ref`` rounds, one per (query,
    key): (B,Sq,Hq,Sk), p = exp(s - m) with m the row's running max at the
    key's tile; NaN at keys before the first tile. The on-card check holds
    the bf16 kernel's own p (``repro_flash_attention_bf16_p``) against it."""
    B, Sq, Hq, _ = q.shape
    Sk = k.shape[1]
    out = torch.full((B, Sq, Hq, Sk), float("nan"), device=q.device)

    def keep(p, k0):   # p (B,Hkv,g,Sq,keys)
        out[..., k0:k0 + p.shape[-1]] = p.permute(0, 3, 1, 2, 4).reshape(
            B, Sq, Hq, p.shape[-1])

    _tiled(q, k, v, causal, window, block_k, lambda p: p, keep)
    return out

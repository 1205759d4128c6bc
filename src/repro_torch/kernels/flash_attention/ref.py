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

"""Shared neural-net layers: norms, activations, RoPE / M-RoPE, initializers.

The same functions as ``repro.models.layers``, in PyTorch. Initializers draw
from an explicit ``torch.Generator`` (the distribution of JAX's, not its
bits); everything else computes what the JAX function computes, in the same
dtypes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import require_no_sharder


# --------------------------------------------------------------------------- #
# Initializers
# --------------------------------------------------------------------------- #
#: elements drawn at once by ``truncated_normal`` for a non-float32 dtype
_DRAW_CHUNK = 1 << 28


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype=torch.float32) -> torch.Tensor:
    """``std`` times a unit normal truncated at +-3, drawn in float32 on the
    generator's device and cast to ``dtype`` (JAX's
    ``std * truncated_normal(key, -3, 3, shape)``). A narrower ``dtype``
    over ``_DRAW_CHUNK`` elements is drawn a chunk at a time, so that the
    float32 draw never holds twice the tensor (grok's and arctic's bf16
    expert stacks on one card)."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    if dtype == torch.float32 or n <= _DRAW_CHUNK:
        t = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                    generator=gen)
        return t.to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view(-1)
    for lo in range(0, n, _DRAW_CHUNK):
        t = torch.empty(min(_DRAW_CHUNK, n - lo), dtype=torch.float32,
                        device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, std, -3.0 * std, 3.0 * std,
                                    generator=gen)
        flat[lo:lo + t.numel()].copy_(t)
    return out


def normal(gen: torch.Generator, shape, std: float, dtype=torch.float32) -> torch.Tensor:
    """``std`` times a unit normal, drawn in float32 on the generator's
    device and cast to ``dtype`` (JAX's ``(std * normal(key, shape))
    .astype(dtype)``)."""
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (std * t).to(dtype)


def dense_init(gen: torch.Generator, shape, in_dim: Optional[int] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (as used by most released LMs)."""
    if in_dim is None:
        in_dim = shape[0]
    return truncated_normal(gen, shape, 1.0 / np.sqrt(in_dim), dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return truncated_normal(gen, shape, 0.02, dtype)


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def rms_norm(x, scale=None, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(dtype)


def layer_norm(x, scale=None, bias=None, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def init_norm(cfg, d: int, device=None) -> dict:
    if cfg.norm == "nonparam_ln":
        return {}
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg, p: dict, x):
    if cfg.norm == "nonparam_ln":
        return layer_norm(x)
    if cfg.norm == "layernorm":
        return layer_norm(x, p.get("scale"), p.get("bias"))
    return rms_norm(x, p.get("scale"))


# --------------------------------------------------------------------------- #
# Activations
# --------------------------------------------------------------------------- #
def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    return F.softplus(x)


# --------------------------------------------------------------------------- #
# RoPE / M-RoPE
# --------------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, dtype=torch.float32,
                     device=None):
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps).to(dtype)


def rope_angles(positions, head_dim: int, theta: float,
                mrope_sections: Optional[tuple] = None):
    """positions: (..., S) int, or (3, ..., S) for M-RoPE. Returns (..., S, half)."""
    half = head_dim // 2
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    if mrope_sections is None:
        return positions[..., None].float() * freqs
    # M-RoPE: each frequency slot i takes its position from section s(i) in (t,h,w)
    assert positions.shape[0] == 3, "M-RoPE needs (3, ..., S) positions"
    sec = np.asarray(mrope_sections)
    assert int(sec.sum()) == half, (mrope_sections, half)
    sel = torch.as_tensor(np.repeat(np.arange(3), sec), device=positions.device)
    pos_pf = torch.movedim(positions[sel], 0, -1)            # (..., S, half)
    return pos_pf.float() * freqs


def apply_rope(x, angles):
    """x: (B, S, H, dh); angles: (B, S, half) -> rotate-half convention."""
    dtype = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)


# --------------------------------------------------------------------------- #
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------- #
def init_mlp(gen: torch.Generator, cfg, d: int, f: int, dtype) -> dict:
    p = {"wi": dense_init(gen, (d, f), d, dtype),
         "wo": dense_init(gen, (f, d), f, dtype)}
    if cfg.act == "swiglu":
        p["wg"] = dense_init(gen, (d, f), d, dtype)
    return p


def apply_mlp(cfg, p: dict, x, sharder=None):
    require_no_sharder(sharder)
    cdt = x.dtype
    h = x @ p["wi"].to(cdt)
    if cfg.act == "swiglu":
        h = silu(x @ p["wg"].to(cdt)) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return h @ p["wo"].to(cdt)


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #
def softmax_xent(logits, labels, mask=None, z_loss: float = 1e-4):
    """Cross-entropy with optional z-loss; logits (..., V) any dtype, labels int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()

"""GQA attention: full / causal / sliding-window; prefill + KV-cache decode.

The same functions as ``repro.models.attention``, in PyTorch. Weights are
stored 2D-flattened ((d, Hq*dh) etc.), as in the JAX package.

``sdpa`` sends the quadratic part to the flash-attention kernel
(``csrc/flash_attention.cu``) under JAX's condition: a kernel backend
(``cuda``), no ``kv_valid_len`` and ``q_offset == 0`` (an int). Every other
call, every decode step included, runs the plain masked path.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import backends
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, rope_angles
from repro_torch.parallel.sharding import require_no_sharder

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype) -> dict:
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, hq * dh), d, dtype),
        "wk": dense_init(gen, (d, hkv * dh), d, dtype),
        "wv": dense_init(gen, (d, hkv * dh), d, dtype),
        "wo": dense_init(gen, (hq * dh, d), hq * dh, dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((n * dh,), dtype=dtype, device=gen.device)
    return p


def qkv_proj(cfg, p, x, positions):
    """x (B,S,D) -> q (B,S,Hq,dh), k/v (B,S,Hkv,dh), RoPE applied."""
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    cdt = x.dtype
    q = x @ p["wq"].to(cdt)
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, cfg.n_heads, dh)
    k = k.reshape(B, S, cfg.n_kv_heads, dh)
    v = v.reshape(B, S, cfg.n_kv_heads, dh)
    if cfg.n_heads > 0 and positions is not None:
        ang = rope_angles(positions, dh, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    return q, k, v


def routes_to_kernel(backend, q_offset=0, kv_valid_len=None) -> bool:
    """Whether ``sdpa`` sends a call to the flash kernel: JAX's condition
    (``models/attention.py``), with ``cuda`` in the place of ``pallas``."""
    return (backend.is_cuda and backend.supports("flash_attention")
            and kv_valid_len is None
            and isinstance(q_offset, int) and q_offset == 0)


def sdpa(q, k, v, *, causal: bool, window: Optional[int] = None,
         q_offset=0, kv_valid_len=None, impl: backends.BackendLike = "ref",
         sharder=None):
    """Scaled dot-product attention with GQA.

    q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh).
    ``q_offset``: absolute position of q[0] (decode: current pos; an int or
    a 0-d tensor).
    ``kv_valid_len``: number of valid KV entries (decode with preallocated cache).
    ``window``: sliding-window size (None = full).
    """
    require_no_sharder(sharder)
    backend = backends.resolve(impl)
    # the flash kernel has no q_offset / kv_valid_len support (decode with a
    # preallocated cache): those calls stay on the plain path
    if routes_to_kernel(backend, q_offset, kv_valid_len):
        return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                         impl=backend)
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(dh)

    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]   # (Sq,1)
    k_pos = torch.arange(Sk, device=q.device)[None, :]              # (1,Sk)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_valid_len is not None:
        mask &= k_pos < kv_valid_len
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, dh)


def attention_block(cfg, p, x, positions, *, causal=True, window=None,
                    sharder=None, impl: backends.BackendLike = "ref"):
    """Full self-attention block (projection + sdpa + output proj)."""
    B, S, D = x.shape
    q, k, v = qkv_proj(cfg, p, x, positions)
    o = sdpa(q, k, v, causal=causal, window=window or cfg.sliding_window,
             impl=impl, sharder=sharder)
    o = o.reshape(B, S, -1)
    return o @ p["wo"].to(x.dtype)


def cross_attention_block(cfg, p, x, kv_src, *, sharder=None,
                          impl: backends.BackendLike = "ref"):
    """Cross-attention (enc-dec): queries from x, keys/values from kv_src."""
    B, S, D = x.shape
    dh = cfg.resolved_head_dim
    cdt = x.dtype
    q = (x @ p["wq"].to(cdt)).reshape(B, S, cfg.n_heads, dh)
    k = (kv_src @ p["wk"].to(cdt)).reshape(B, kv_src.shape[1], cfg.n_kv_heads, dh)
    v = (kv_src @ p["wv"].to(cdt)).reshape(B, kv_src.shape[1], cfg.n_kv_heads, dh)
    o = sdpa(q, k, v, causal=False, impl=impl, sharder=sharder)
    return o.reshape(B, S, -1) @ p["wo"].to(cdt)


# --------------------------------------------------------------------------- #
# KV-cache decode
# --------------------------------------------------------------------------- #
def cache_update(cache_k, cache_v, k, v, pos, window: Optional[int] = None):
    """Insert one step's k/v (B,1,Hkv,dh) at position ``pos`` (an int or a
    0-d tensor); ring buffer if SWA. Updates ``cache_k`` / ``cache_v`` in
    place (JAX returns new arrays; the port saves the copy) and returns
    them. A position past the cache is clamped to its last slot, as
    ``jax.lax.dynamic_update_slice`` clamps."""
    S = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=cache_k.device)
    idx = torch.clamp(pos, max=S - 1) if window is None else pos % S
    idx = idx.reshape(1).long()
    cache_k.index_copy_(1, idx, k.to(cache_k.dtype))
    cache_v.index_copy_(1, idx, v.to(cache_v.dtype))
    return cache_k, cache_v


def decode_attention(cfg, p, x, cache_k, cache_v, pos, *, window=None,
                     sharder=None):
    """One-token decode: x (B,1,D), cache (B,Smax,Hkv,dh), pos scalar. The
    cache is updated in place (see :func:`cache_update`)."""
    require_no_sharder(sharder)
    B = x.shape[0]
    positions = _decode_positions(cfg, pos, B, x.device)
    q, k, v = qkv_proj(cfg, p, x, positions)
    ck, cv = cache_update(cache_k, cache_v, k, v, pos, window)
    if window is None:
        o = sdpa(q, ck, cv, causal=False, kv_valid_len=pos + 1, q_offset=pos)
    else:
        # ring buffer: the buffer holds exactly the last W positions, so all
        # slots written so far are valid; mask unwritten slots only
        o = sdpa(q, ck, cv, causal=False,
                 kv_valid_len=torch.clamp(torch.as_tensor(pos, device=x.device) + 1,
                                          max=ck.shape[1]))
    o = o.reshape(B, 1, -1)
    return o @ p["wo"].to(x.dtype), ck, cv


def _decode_positions(cfg, pos, B, device=None):
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(1, 1)
    p = p.expand(B, 1)
    if cfg.mrope_sections is not None:
        p = p[None].expand(3, B, 1)
    return p

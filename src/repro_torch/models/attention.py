"""GQA attention: full / causal / sliding-window; prefill + KV-cache decode.

The same functions as ``repro.models.attention``, in PyTorch. Weights are
stored 2D-flattened ((d, Hq*dh) etc.), as in the JAX package.

``sdpa`` sends the quadratic part to the flash-attention kernel
(``csrc/flash_attention.cu``) under JAX's condition: a kernel backend
(``cuda``), no ``kv_valid_len`` and ``q_offset == 0`` (an int). Every other
call, every decode step included, runs the plain masked path.

On a mesh (a ``sharder`` with one) the input ``x`` is the rank's batch
block, whole over ``"model"``, and the weights are the rank's blocks over
``"model"`` (``parallel.sharding.shard_params``), which the layer has
gathered whole over ``"data"`` before any of them is read
(``transformer.gather_fsdp``). :func:`attention_block` runs in one of
three modes, as XLA partitions JAX's block:

- heads (``Hq`` divides over ``"model"``): the rank's q heads and the K/V
  heads they read (gathered when the K/V heads do not split evenly, e.g.
  qwen2's 2 on a 4-wide axis), flash on the kernel path, ``wo``'s rows and
  a psum over ``"model"``;
- sequence (JAX's ``_seq_parallel_mode``: ``Hq`` does not divide, the
  sequence does, e.g. qwen2's 14 heads or arctic's 56 on a 4-wide axis):
  q moves from column blocks to the rank's query rows by one all_to_all
  (``Sharder.constrain`` from the layout it holds to JAX's ``"seq"``
  constraint), K/V are gathered whole, the rank attends rows
  ``[r*s, (r+1)*s)`` against keys ``[0, (r+1)*s)`` (the kernel right-aligns
  queries to keys, which is JAX's causal mask), and the output goes back by
  the reverse all_to_all;
- whole (neither divides, e.g. a decode step of qwen2): every head on every
  rank, then ``wo``'s rows.

:func:`decode_attention` holds the cache cut over ``"seq"`` (the slots,
JAX's ``decode_attention`` constraint) where the slot count divides: each
rank attends over its slots and the ranks combine their softmax sums.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import backends
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, rope_angles
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import mesh_sharder, model_split

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
         q_offset=0, kv_valid_len=None, impl: backends.BackendLike = "ref"):
    """Scaled dot-product attention with GQA, on one rank's tensors (on a
    mesh, :func:`attention_block` splits the heads or the query rows).

    q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh).
    ``q_offset``: absolute position of q[0] (decode: current pos; an int or
    a 0-d tensor).
    ``kv_valid_len``: number of valid KV entries (decode with preallocated cache).
    ``window``: sliding-window size (None = full).
    """
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


def _seq_parallel_mode(sharder, Hq: int, Sq: int) -> bool:
    """JAX's condition for sequence-parallel attention: the query heads do
    not divide the model axis and the query rows do."""
    if sharder is None or sharder.mesh is None:
        return False
    m = sharder.axis_size("model")
    return m > 1 and Hq % m != 0 and Sq % m == 0 and Sq > 1


def _attend_rows(q, k, v, q_start: int, *, causal, window, backend):
    """Query rows ``[q_start, q_start + Sq)`` against the keys ``[0, Sk)``:
    the flash kernel on the keys up to the last row (it right-aligns the
    rows to them), else the plain path with ``q_offset``."""
    if routes_to_kernel(backend) and causal:
        end = q_start + q.shape[1]
        return flash_ops.flash_attention(q, k[:, :end], v[:, :end], causal=True,
                                         window=window, impl=backend)
    if routes_to_kernel(backend) and q_start == 0 and q.shape[1] == k.shape[1]:
        return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                         impl=backend)
    return sdpa(q, k, v, causal=causal, window=window, q_offset=q_start,
                impl="ref")


def _kv_heads(lo: int, n: int, Hq: int, Hkv: int):
    """The K/V heads q heads ``[lo, lo + n)`` read: a slice (whole GQA
    groups, or one K/V head shared by all n) or, where the n heads cut
    groups unevenly, an index per q head."""
    g = Hq // Hkv
    if n % g == 0:
        return slice(lo // g, (lo + n) // g)
    if g % n == 0:
        return slice(lo // g, lo // g + 1)
    return torch.arange(lo, lo + n) // g


def _projection(cfg, p, x, xe, name, heads, sh):
    """``x @ w`` (+ bias) for one of q / k / v: (values, split) with values
    this rank's columns when the model axis cuts ``heads * dh`` (from the
    entered ``xe``), else all of them (from ``x``)."""
    split = model_split(sh, heads * cfg.resolved_head_dim)
    src = xe if split else x
    y = src @ p["w" + name].to(x.dtype)
    if cfg.qkv_bias:
        y = y + p["b" + name].to(x.dtype)
    return y, split


def _rope(cfg, t, positions):
    if cfg.n_heads > 0 and positions is not None:
        return apply_rope(t, rope_angles(positions, cfg.resolved_head_dim,
                                         cfg.rope_theta, cfg.mrope_sections))
    return t


def attention_mode(sharder, cfg, S: int) -> str:
    """``"heads"``, ``"seq"`` or ``"whole"`` (see the module docstring) for
    a block of ``S`` query rows on ``sharder``'s mesh."""
    if sharder.axis_size("model") == 1 or cfg.n_heads % sharder.axis_size("model") == 0:
        return "heads"
    return "seq" if _seq_parallel_mode(sharder, cfg.n_heads, S) else "whole"


def attention_tp(cfg, p, x, positions, sh, *, causal=True, window=None,
                 impl: backends.BackendLike = "ref", with_kv: bool = False):
    """:func:`attention_block` on a mesh whose model axis is wider than 1
    (``sh`` a sharder with one): (out, k, v), out whole over ``"model"``
    and, when ``with_kv``, k / v (B,S,Hkv,dh) with every K/V head (the
    prefill's cache), else None."""
    mesh, M = sh.mesh, "model"
    m, r = mesh.axis_size(M), mesh.axis_index(M)
    backend = backends.resolve(impl)
    B, S, _ = x.shape
    dh, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    mode = attention_mode(sh, cfg, S)
    xe = col.enter(x, mesh, M)
    q, q_split = _projection(cfg, p, x, xe, "q", Hq, sh)
    k, kv_split = _projection(cfg, p, x, xe, "k", Hkv, sh)
    v, _ = _projection(cfg, p, x, xe, "v", Hkv, sh)
    div = q_split or mode == "seq"      # the ranks' work differs from here
    local_kv = mode == "heads" and kv_split and Hkv % m == 0

    def whole(t):                        # every K/V (or q) column on this rank
        if kv_split:
            return col.all_gather_dim(t, mesh, M, 2) if div else col.gather(t, mesh, M, 2)
        return col.enter(t, mesh, M) if div else t

    if not local_kv:
        k, v = whole(k), whole(v)
    k = _rope(cfg, k.reshape(B, S, -1, dh), positions)
    v = v.reshape(B, S, -1, dh)
    if mode == "heads":
        n = Hq // m
        q = _rope(cfg, q.reshape(B, S, n, dh), positions)
        kk, vv = (k, v) if local_kv else (k[:, :, _kv_heads(r * n, n, Hq, Hkv)],
                                          v[:, :, _kv_heads(r * n, n, Hq, Hkv)])
        o = _attend_rows(q, kk, vv, 0, causal=causal, window=window, backend=backend)
        out = col.reduce(o.reshape(B, S, -1) @ p["wo"].to(x.dtype), mesh, M)
    elif mode == "seq":
        s = S // m
        q = sh.constrain(q, "batch", "seq", None,
                         held=("batch", None, "model" if q_split else None))
        rows = positions[..., r * s:(r + 1) * s]
        q = _rope(cfg, q.reshape(B, s, Hq, dh), rows)
        o = _attend_rows(q, k, v, r * s, causal=causal, window=window,
                         backend=backend).reshape(B, s, -1)
        if q_split:
            o = sh.constrain(o, "batch", None, "model", held=("batch", "seq", None))
            out = col.reduce(o @ p["wo"].to(x.dtype), mesh, M)
        else:
            out = sh.constrain(o @ col.enter(p["wo"], mesh, M).to(x.dtype),
                               "batch", None, None, held=("batch", "seq", None))
    else:
        if q_split:
            q = col.all_gather_dim(q, mesh, M, 2)
        q = _rope(cfg, q.reshape(B, S, Hq, dh), positions)
        o = _attend_rows(q, k, v, 0, causal=causal, window=window,
                         backend=backend).reshape(B, S, -1)
        if q_split:
            c = o.shape[-1] // m
            out = col.reduce(o[..., r * c:(r + 1) * c] @ p["wo"].to(x.dtype), mesh, M)
        else:
            out = o @ p["wo"].to(x.dtype)
    if not with_kv:
        return out, None, None
    if local_kv:                         # the cache holds every K/V head
        k, v = (col.all_gather_dim(t.detach(), mesh, M, 2) for t in (k, v))
    return out, k, v


def attention_block(cfg, p, x, positions, *, causal=True, window=None,
                    sharder=None, impl: backends.BackendLike = "ref"):
    """Full self-attention block (projection + sdpa + output proj); on a
    mesh, :func:`attention_tp`."""
    sh = mesh_sharder(sharder)
    if sh is not None and sh.axis_size("model") > 1:
        return attention_tp(cfg, p, x, positions, sh, causal=causal,
                            window=window or cfg.sliding_window, impl=impl)[0]
    B, S, D = x.shape
    q, k, v = qkv_proj(cfg, p, x, positions)
    o = sdpa(q, k, v, causal=causal, window=window or cfg.sliding_window,
             impl=impl)
    o = o.reshape(B, S, -1)
    return o @ p["wo"].to(x.dtype)


def attention_with_kv(cfg, p, x, positions, sh, *, window=None,
                      impl: backends.BackendLike = "ref"):
    """A prefill's causal attention block: (out, k, v), k / v (B,S,Hkv,dh)
    with every K/V head (the cache's); :func:`attention_tp` on a mesh whose
    model axis is wider than 1."""
    if sh is not None and sh.axis_size("model") > 1:
        return attention_tp(cfg, p, x, positions, sh, window=window, impl=impl,
                            with_kv=True)
    B, S, _ = x.shape
    q, k, v = qkv_proj(cfg, p, x, positions)
    o = sdpa(q, k, v, causal=True, window=window, impl=impl)
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype), k, v


def cross_attention_block(cfg, p, x, kv_src, *, sharder=None,
                          impl: backends.BackendLike = "ref"):
    """Cross-attention (enc-dec): queries from x, keys/values from kv_src.
    No rule of the sharding places its weights (``decoder/layers/cross/*``
    lacks ``attn/``), so on a mesh every rank holds them whole and runs the
    whole block on its batch rows, as JAX's block (no constraint) runs;
    ``sharder`` is accepted for JAX's signature and not read."""
    B, S, D = x.shape
    dh = cfg.resolved_head_dim
    cdt = x.dtype
    q = (x @ p["wq"].to(cdt)).reshape(B, S, cfg.n_heads, dh)
    k = (kv_src @ p["wk"].to(cdt)).reshape(B, kv_src.shape[1], cfg.n_kv_heads, dh)
    v = (kv_src @ p["wv"].to(cdt)).reshape(B, kv_src.shape[1], cfg.n_kv_heads, dh)
    o = sdpa(q, k, v, causal=False, impl=impl)
    return o.reshape(B, S, -1) @ p["wo"].to(cdt)


# --------------------------------------------------------------------------- #
# KV-cache decode
# --------------------------------------------------------------------------- #
def mesh_cache(cache, keys, sh, W: int) -> tuple:
    """(lo, c): this rank's block ``[lo, lo + c)`` of a prefill cache's
    ``W`` slots (dimension 2 of each of ``keys``, (L, B, W, Hkv, dh)). On a
    mesh whose model axis is wider than 1 and divides ``W``, its block over
    ``"seq"``, those entries cut to it; there ``cache["slots"] = W`` holds
    the global count, which :func:`decode_attention` reads. Else all of
    them."""
    lo, c = 0, W
    if sh is not None and sh.axis_size("model") > 1:
        m = sh.axis_size("model")
        if W % m == 0:
            c = W // m
            lo = sh.mesh.axis_index("model") * c
            for key in keys:
                cache[key] = cache[key][:, :, lo:lo + c].clone()
        cache["slots"] = W
    return lo, c


def prompt_slots(S: int, W: int, lo: int, c: int, device):
    """(dst, src): the prompt's last ``min(S, W)`` positions ``src``, each at
    its decode slot (``p % W``), that fall in the cache block ``[lo, lo +
    c)``, and those slots' offsets ``dst`` in the block."""
    keep = min(S, W)
    pos = torch.arange(S - keep, S, device=device)
    slots = pos % W
    mine = (slots >= lo) & (slots < lo + c)
    return slots[mine] - lo, pos[mine]


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
                     sharder=None, slots=None):
    """One-token decode: x (B,1,D), cache (B,Smax,Hkv,dh), pos scalar. The
    cache is updated in place (see :func:`cache_update`).

    On a mesh whose model axis is wider than 1, ``slots`` is the cache's
    global slot count and ``cache_k`` / ``cache_v`` this rank's block of
    them over ``"seq"`` (all of them when the count does not divide): the
    rank that holds the slot of ``pos`` writes it, every rank attends over
    its slots and the ranks combine their softmax sums (psum over
    ``"model"``); then ``wo``'s rows and a psum. Not differentiated."""
    sh = mesh_sharder(sharder)
    if sh is not None and sh.axis_size("model") > 1:
        return _decode_tp(cfg, p, x, cache_k, cache_v, pos, window, sh,
                          cache_k.shape[1] if slots is None else slots)
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


@torch.no_grad()
def _decode_tp(cfg, p, x, cache_k, cache_v, pos, window, sh, slots: int):
    mesh, M = sh.mesh, "model"
    m, r = mesh.axis_size(M), mesh.axis_index(M)
    B = x.shape[0]
    dh, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    positions = _decode_positions(cfg, pos, B, x.device)
    q, q_split = _projection(cfg, p, x, x, "q", Hq, sh)
    k, kv_split = _projection(cfg, p, x, x, "k", Hkv, sh)
    v, _ = _projection(cfg, p, x, x, "v", Hkv, sh)
    if q_split:
        q = col.all_gather_dim(q, mesh, M, 2)
    if kv_split:
        k, v = col.all_gather_dim(k, mesh, M, 2), col.all_gather_dim(v, mesh, M, 2)
    q = _rope(cfg, q.reshape(B, 1, Hq, dh), positions)
    k = _rope(cfg, k.reshape(B, 1, Hkv, dh), positions)
    v = v.reshape(B, 1, Hkv, dh)
    c = cache_k.shape[1]
    lo = r * c if c != slots else 0                # this rank's first slot
    pos_t = torch.as_tensor(pos, device=x.device)
    idx = torch.clamp(pos_t, max=slots - 1) if window is None else pos_t % slots
    mine = (idx >= lo) & (idx < lo + c)
    at = (torch.clamp(idx - lo, 0, c - 1)).reshape(1).long()
    keep_k, keep_v = cache_k.index_select(1, at), cache_v.index_select(1, at)
    cache_k.index_copy_(1, at, torch.where(mine, k.to(cache_k.dtype), keep_k))
    cache_v.index_copy_(1, at, torch.where(mine, v.to(cache_v.dtype), keep_v))
    valid = pos_t + 1 if window is None else torch.clamp(pos_t + 1, max=slots)
    g = Hq // Hkv
    qg = q.reshape(B, 1, Hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, cache_k).float() / math.sqrt(dh)
    k_pos = lo + torch.arange(c, device=x.device)
    scores = torch.where(k_pos < valid, scores, NEG_INF)
    top = col.pmax(scores.amax(-1, keepdim=True), mesh, M) if c != slots \
        else scores.amax(-1, keepdim=True)
    e = torch.exp(scores - top)
    den = e.sum(-1, keepdim=True)
    num = torch.einsum("bhgqk,bkhd->bhgqd", e, cache_v.float())
    if c != slots:
        den, num = col.psum(den, mesh, M), col.psum(num, mesh, M)
    o = (num / den).to(q.dtype)                              # (B,Hkv,g,1,dh)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, Hq * dh)
    if q_split:
        w = o.shape[-1] // m
        out = col.psum(o[..., r * w:(r + 1) * w] @ p["wo"].to(x.dtype), mesh, M)
    else:
        out = o @ p["wo"].to(x.dtype)
    return out, cache_k, cache_v


def _decode_positions(cfg, pos, B, device=None):
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(1, 1)
    p = p.expand(B, 1)
    if cfg.mrope_sections is not None:
        p = p[None].expand(3, B, 1)
    return p

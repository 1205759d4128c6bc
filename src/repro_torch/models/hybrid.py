"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention + MLP
block applied after every ``hybrid_shared_every``-th mamba layer.

The same functions as ``repro.models.hybrid``, in PyTorch (Python loops in
the place of ``lax.scan``). Where a gradient is taken, each mamba layer and
each application of the shared block runs under the config's remat policy
(JAX nests a group's remat around its layers'; the values are the same).
38 layers with period 6 give 6 groups of 6 mamba layers, each followed by
the shared block, then a tail of 2 mamba layers. The shared block's prefill attention goes through ``sdpa``, which
sends it to the flash kernel on the ``cuda`` backend.

``hybrid_prefill`` puts the prompt's KV at the head of a ``seq_len`` cache,
as JAX's does (which continues the prompt: position p at slot p);
``hybrid_decode_step`` writes the new states and KV rows into the cache's
tensors and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed_init, init_mlp, init_norm,
    softmax_xent,
)
from repro_torch.models.transformer import (
    _as_tensor, _stacked_norm, compute_dtype, embed_tokens, layer_slices,
    logits_fn, make_positions, param_dtype, remat_wrap,
)
from repro_torch.parallel.sharding import padded_vocab, require_no_sharder


def group_structure(cfg):
    """(n_groups, group_size, n_tail) with n_groups*group_size + n_tail = n_layers."""
    g = cfg.hybrid_shared_every
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


def _init_mamba_stack(cfg, gen, pdt, n):
    return {"ssm": mamba2.init_ssm_params(gen, cfg, pdt, (n,)),
            "norm1": _stacked_norm(cfg, n, cfg.d_model, gen.device)}


def init_hybrid(cfg, gen: torch.Generator) -> dict:
    """Random parameters in the JAX tree layout, drawn from ``gen`` on its
    device."""
    pdt = param_dtype(cfg)
    vp = padded_vocab(cfg.vocab)
    n_groups, g, tail = group_structure(cfg)
    d, dev = cfg.d_model, gen.device
    params = {
        "embed": {"tok": embed_init(gen, (vp, d), pdt)},
        "groups": _init_mamba_stack(cfg, gen, pdt, n_groups * g),
        "shared": {
            "attn": attn.init_attention(gen, cfg, pdt),
            "mlp": init_mlp(gen, cfg, d, cfg.d_ff, pdt),
            "norm1": init_norm(cfg, d, dev),
            "norm2": init_norm(cfg, d, dev),
        },
        "final_norm": init_norm(cfg, d, dev),
    }
    if tail:
        params["tail"] = _init_mamba_stack(cfg, gen, pdt, tail)
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (d, vp), d, pdt)}
    return params


def _mamba_layers(cfg, params):
    """Each mamba layer's params in order, with the index of the group it
    closes (None inside a group and in the tail)."""
    n_groups, g, tail = group_structure(cfg)
    for i, lp in enumerate(layer_slices(params["groups"], n_groups * g)):
        yield lp, (i // g if i % g == g - 1 else None)
    if tail:
        for lp in layer_slices(params["tail"], tail):
            yield lp, None


def _shared_block(cfg, sp, x, positions, impl):
    h = apply_norm(cfg, sp["norm1"], x)
    x = x + attn.attention_block(cfg, sp["attn"], h, positions, causal=True,
                                 impl=impl)
    h2 = apply_norm(cfg, sp["norm2"], x)
    return x + apply_mlp(cfg, sp["mlp"], h2)


def forward_hidden(cfg, params, x, positions, sharder=None, impl="ref"):
    require_no_sharder(sharder)
    mamba = remat_wrap(cfg, lambda xx, lp: xx + mamba2.mamba2_block(
        cfg, lp["ssm"], apply_norm(cfg, lp["norm1"], xx)))
    shared = remat_wrap(cfg, lambda xx: _shared_block(cfg, params["shared"], xx,
                                                      positions, impl))
    for lp, closes in _mamba_layers(cfg, params):
        x = mamba(x, lp)
        if closes is not None:
            x = shared(x)
    return apply_norm(cfg, params["final_norm"], x)


def hybrid_loss(cfg, params, batch, sharder=None, impl="ref"):
    x = embed_tokens(cfg, params, batch["tokens"])
    B, S = x.shape[:2]
    positions = make_positions(cfg, B, S, x.device)
    h = forward_hidden(cfg, params, x, positions, sharder, impl)
    logits = logits_fn(cfg, params, h)
    loss = softmax_xent(logits, _as_tensor(batch["labels"], h.device, torch.long))
    return loss, {"xent": loss}


# --------------------------------------------------------------------------- #
# Prefill / Decode
# --------------------------------------------------------------------------- #
@torch.no_grad()
def hybrid_prefill(cfg, params, batch, seq_len: int, sharder=None, impl="ref"):
    """Prompt pass with state capture: mamba states a layer, the shared
    block's KV a group at the head of a ``seq_len`` cache."""
    require_no_sharder(sharder)
    cdt = compute_dtype(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    B, S = x.shape[:2]
    if S > seq_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"seq_len={seq_len}")
    positions = make_positions(cfg, B, S, x.device)
    cache = init_hybrid_cache(cfg, B, seq_len, x.device)
    sp = params["shared"]
    for i, (lp, closes) in enumerate(_mamba_layers(cfg, params)):
        h = apply_norm(cfg, lp["norm1"], x)
        y, s, c = mamba2.mamba2_block_state(cfg, lp["ssm"], h)
        x = x + y
        cache["ssm"][i].copy_(s)
        cache["conv"][i].copy_(c)
        if closes is None:
            continue
        h = apply_norm(cfg, sp["norm1"], x)
        q, k, v = attn.qkv_proj(cfg, sp["attn"], h, positions)
        o = attn.sdpa(q, k, v, causal=True, impl=impl)
        x = x + o.reshape(B, S, -1) @ sp["attn"]["wo"].to(cdt)
        h2 = apply_norm(cfg, sp["norm2"], x)
        x = x + apply_mlp(cfg, sp["mlp"], h2)
        cache["k"][closes, :, :S] = k
        cache["v"][closes, :, :S] = v
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_fn(cfg, params, x[:, -1:])
    cache["pos"].fill_(S)
    return logits, cache


def init_hybrid_cache(cfg, batch: int, seq_len: int, device=None):
    n_groups, _, _ = group_structure(cfg)
    cdt = compute_dtype(cfg)
    dh = cfg.resolved_head_dim
    cache = mamba2.init_mamba_cache(cfg, batch, cdt, device, (cfg.n_layers,))
    kv = (n_groups, batch, seq_len, cfg.n_kv_heads, dh)
    cache["k"] = torch.zeros(kv, dtype=cdt, device=device)
    cache["v"] = torch.zeros(kv, dtype=cdt, device=device)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


@torch.no_grad()
def hybrid_decode_step(cfg, params, cache, tokens, sharder=None):
    require_no_sharder(sharder)
    x = embed_tokens(cfg, params, tokens)
    pos = _as_tensor(cache["pos"], x.device, torch.int32)
    sp = params["shared"]
    for i, (lp, closes) in enumerate(_mamba_layers(cfg, params)):
        h = apply_norm(cfg, lp["norm1"], x)
        y, new = mamba2.mamba2_decode_step(
            cfg, lp["ssm"], h, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]})
        x = x + y
        cache["ssm"][i].copy_(new["ssm"])
        cache["conv"][i].copy_(new["conv"])
        if closes is None:
            continue
        h = apply_norm(cfg, sp["norm1"], x)
        o, _, _ = attn.decode_attention(cfg, sp["attn"], h, cache["k"][closes],
                                        cache["v"][closes], pos)
        x = x + o
        h2 = apply_norm(cfg, sp["norm2"], x)
        x = x + apply_mlp(cfg, sp["mlp"], h2)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_fn(cfg, params, x)
    return logits, {"ssm": cache["ssm"], "conv": cache["conv"], "k": cache["k"],
                    "v": cache["v"], "pos": pos + 1}


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

On a mesh (a ``sharder`` with one; ``places`` the blocks' placements,
``Model.places``) the mamba layers and the tail run as
``ssm_lm``'s do (each gathered over ``"data"`` inside its checkpoint,
head-parallel over ``"model"``). The shared block's leaves match the
attention and MLP rules, so they are cut over ``"data"`` and ``"model"``;
the block is gathered over ``"data"`` at each application, inside that
application's checkpoint, and runs the dense layer's mesh path
(``attention.attention_tp``, ``layers.apply_mlp``). Its gradient is the
sum of its applications' (autograd adds them). The cache holds the
rank's batch rows and heads, and each group's shared-block K/V cut over
``"seq"`` as the transformer's (``attention.mesh_cache``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed_init, init_mlp, init_norm,
)
from repro_torch.models.ssm_lm import ssm_layer
from repro_torch.models.transformer import (
    _as_tensor, _stacked_norm, _used, compute_dtype, embed_tokens, gather_fsdp,
    lm_xent, make_positions, mesh_entry, param_dtype, remat_wrap, stack_layers,
    sub_places, whole_logits,
)
from repro_torch.parallel.sharding import mesh_sharder, padded_vocab


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


def _mamba_layers(cfg, params, places, sh):
    """Each mamba layer in order as ``(whole, lp, closes)``: its params,
    the function that gathers them whole over ``"data"``
    (``transformer.stack_layers``) and the index of the group it closes
    (None inside a group and in the tail)."""
    n_groups, g, tail = group_structure(cfg)
    for key, n in (("groups", n_groups * g), ("tail", tail)):
        if not n:
            continue
        whole, layers = stack_layers(params, places, sh, n, key)
        for i, lp in enumerate(layers):
            yield whole, lp, (i // g if key == "groups" and i % g == g - 1 else None)


def _shared_block(cfg, sp, x, positions, sh, impl):
    h = apply_norm(cfg, sp["norm1"], x)
    x = x + attn.attention_block(cfg, sp["attn"], h, positions, causal=True,
                                 sharder=sh, impl=impl)
    h2 = apply_norm(cfg, sp["norm2"], x)
    return x + apply_mlp(cfg, sp["mlp"], h2, sh)


def forward_hidden(cfg, params, x, positions, sharder=None, impl="ref", places=None):
    sh = mesh_sharder(sharder)
    splaces = sub_places(places, "shared")
    mamba = remat_wrap(cfg, lambda xx, lp, whole: ssm_layer(cfg, whole(lp), xx, sh))
    shared = remat_wrap(cfg, lambda xx, sp: _shared_block(
        cfg, gather_fsdp(sp, splaces, sh), xx, positions, sh, impl))
    for whole, lp, closes in _mamba_layers(cfg, params, places, sh):
        x = mamba(x, lp, whole)
        if closes is not None:
            x = shared(x, params["shared"])
    return apply_norm(cfg, _used(params, places, sh, "final_norm"), x)


def hybrid_loss(cfg, params, batch, sharder=None, impl="ref", *, places):
    sh, params = mesh_entry(sharder, params, places)
    x = embed_tokens(cfg, params, batch["tokens"], sh, places)
    B, S = x.shape[:2]
    positions = make_positions(cfg, B, S, x.device)
    h = forward_hidden(cfg, params, x, positions, sh, impl, places)
    loss = lm_xent(cfg, params, h, batch["labels"], sh, places)
    return loss, {"xent": loss}


# --------------------------------------------------------------------------- #
# Prefill / Decode
# --------------------------------------------------------------------------- #
@torch.no_grad()
def hybrid_prefill(cfg, params, batch, seq_len: int, sharder=None, impl="ref", *,
                   places):
    """Prompt pass with state capture: mamba states a layer, the shared
    block's KV a group at the head of a ``seq_len`` cache."""
    sh = mesh_sharder(sharder)
    cdt = compute_dtype(cfg)
    x = embed_tokens(cfg, params, batch["tokens"], sh, places)
    B, S = x.shape[:2]
    if S > seq_len:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"seq_len={seq_len}")
    positions = make_positions(cfg, B, S, x.device)
    cache = init_hybrid_cache(cfg, B, seq_len, x.device, sh)
    lo, c = attn.mesh_cache(cache, ("k", "v"), sh, seq_len)
    dst, src = attn.prompt_slots(S, seq_len, lo, c, x.device)
    sp = None
    for i, (whole, lp, closes) in enumerate(_mamba_layers(cfg, params, places, sh)):
        lp = whole(lp)
        h = apply_norm(cfg, lp["norm1"], x)
        y, s, cv = mamba2.mamba2_block_state(cfg, lp["ssm"], h, sh)
        x = x + y
        cache["ssm"][i].copy_(s)
        cache["conv"][i].copy_(cv)
        if closes is None:
            continue
        sp = sp or gather_fsdp(params["shared"], sub_places(places, "shared"), sh)
        h = apply_norm(cfg, sp["norm1"], x)
        o, k, v = attn.attention_with_kv(cfg, sp["attn"], h, positions, sh, impl=impl)
        x = x + o
        h2 = apply_norm(cfg, sp["norm2"], x)
        x = x + apply_mlp(cfg, sp["mlp"], h2, sh)
        cache["k"][closes].index_copy_(1, dst, k[:, src].to(cdt))
        cache["v"][closes].index_copy_(1, dst, v[:, src].to(cdt))
    x = apply_norm(cfg, _used(params, places, sh, "final_norm"), x)
    logits = whole_logits(cfg, params, x[:, -1:], sh, places)
    cache["pos"].fill_(S)
    return logits, cache


def init_hybrid_cache(cfg, batch: int, seq_len: int, device=None, sharder=None):
    n_groups, _, _ = group_structure(cfg)
    cdt = compute_dtype(cfg)
    dh = cfg.resolved_head_dim
    cache = mamba2.init_mamba_cache(cfg, batch, cdt, device, (cfg.n_layers,), sharder)
    kv = (n_groups, batch, seq_len, cfg.n_kv_heads, dh)
    cache["k"] = torch.zeros(kv, dtype=cdt, device=device)
    cache["v"] = torch.zeros(kv, dtype=cdt, device=device)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


@torch.no_grad()
def hybrid_decode_step(cfg, params, cache, tokens, sharder=None, *, places):
    sh = mesh_sharder(sharder)
    x = embed_tokens(cfg, params, tokens, sh, places)
    pos = _as_tensor(cache["pos"], x.device, torch.int32)
    slots = cache.get("slots")
    sp = None
    for i, (whole, lp, closes) in enumerate(_mamba_layers(cfg, params, places, sh)):
        lp = whole(lp)
        h = apply_norm(cfg, lp["norm1"], x)
        y, new = mamba2.mamba2_decode_step(
            cfg, lp["ssm"], h, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}, sh)
        x = x + y
        cache["ssm"][i].copy_(new["ssm"])
        cache["conv"][i].copy_(new["conv"])
        if closes is None:
            continue
        sp = sp or gather_fsdp(params["shared"], sub_places(places, "shared"), sh)
        h = apply_norm(cfg, sp["norm1"], x)
        o, _, _ = attn.decode_attention(cfg, sp["attn"], h, cache["k"][closes],
                                        cache["v"][closes], pos, sharder=sh,
                                        slots=slots)
        x = x + o
        h2 = apply_norm(cfg, sp["norm2"], x)
        x = x + apply_mlp(cfg, sp["mlp"], h2, sh)
    x = apply_norm(cfg, _used(params, places, sh, "final_norm"), x)
    logits = whole_logits(cfg, params, x, sh, places)
    out = {"ssm": cache["ssm"], "conv": cache["conv"], "k": cache["k"],
           "v": cache["v"], "pos": pos + 1}
    if slots is not None:
        out["slots"] = slots
    return logits, out

"""Mamba2 language model (attention-free): embed -> stacked SSD layers ->
head.

The same functions as ``repro.models.ssm_lm``, in PyTorch: a Python loop
over the stacked layer slices takes the place of ``lax.scan``, each layer
under the config's remat policy where a gradient is taken. The cache
is ``{"ssm": (L,B,H,P,N) f32, "conv": (L,B,W-1,Cd), "pos"}``: O(1) in the
context length, so ``seq_len`` sizes nothing. ``ssm_decode_step`` writes
the new states into the cache's tensors (JAX returns new arrays; the port
saves the copy) and returns them.

On a mesh (a ``sharder`` with one; ``places`` the blocks' placements,
``Model.places``) the model runs as the transformer's does
(``models.transformer``): each layer's leaves gathered over ``"data"``
inside the function ``remat_wrap`` checkpoints, the block head-parallel
over ``"model"`` (``mamba2.rank_view``), the tied embedding's lookup, the
logits and the cross-entropy vocab-parallel, the loss the global batch's
mean and each rank's gradient its block of the global one; the cache
holds the rank's batch rows and heads (``mamba2.init_mamba_cache``).
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba2
from repro_torch.models.layers import apply_norm, dense_init, embed_init, init_norm
from repro_torch.models.transformer import (
    _as_tensor, _stacked_norm, _used, compute_dtype, embed_tokens, gathered_layers,
    lm_xent, mesh_entry, param_dtype, remat_wrap, stack_layers, whole_logits,
)
from repro_torch.parallel.sharding import mesh_sharder, padded_vocab


def init_ssm_lm(cfg, gen: torch.Generator) -> dict:
    """Random parameters in the JAX tree layout (tied embeddings where the
    config ties them), drawn from ``gen`` on its device."""
    pdt = param_dtype(cfg)
    vp = padded_vocab(cfg.vocab)
    d, L = cfg.d_model, cfg.n_layers
    params = {
        "embed": {"tok": embed_init(gen, (vp, d), pdt)},
        "layers": {
            "ssm": mamba2.init_ssm_params(gen, cfg, pdt, (L,)),
            "norm1": _stacked_norm(cfg, L, d, gen.device),
        },
        "final_norm": init_norm(cfg, d, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (d, vp), d, pdt)}
    return params


def ssm_layer(cfg, lp, x, sh):
    """One residual Mamba2 layer (``lp`` whole over ``"data"``)."""
    return x + mamba2.mamba2_block(cfg, lp["ssm"], apply_norm(cfg, lp["norm1"], x), sh)


def forward_hidden(cfg, params, x, sharder=None, places=None):
    sh = mesh_sharder(sharder)
    whole, layers = stack_layers(params, places, sh, cfg.n_layers, "layers")
    body = remat_wrap(cfg, lambda xx, lp: ssm_layer(cfg, whole(lp), xx, sh))
    for lp in layers:
        x = body(x, lp)
    return apply_norm(cfg, _used(params, places, sh, "final_norm"), x)


def ssm_loss(cfg, params, batch, sharder=None, *, places):
    sh, params = mesh_entry(sharder, params, places)
    x = embed_tokens(cfg, params, batch["tokens"], sh, places)
    h = forward_hidden(cfg, params, x, sh, places)
    loss = lm_xent(cfg, params, h, batch["labels"], sh, places)
    return loss, {"xent": loss}


def init_ssm_cache(cfg, batch: int, device=None, sharder=None):
    cache = mamba2.init_mamba_cache(cfg, batch, compute_dtype(cfg), device,
                                    (cfg.n_layers,), sharder)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


@torch.no_grad()
def ssm_prefill(cfg, params, batch, sharder=None, *, places):
    """Run the prompt via the chunked scan, capturing each layer's final
    states: (last-token logits, cache)."""
    sh = mesh_sharder(sharder)
    x = embed_tokens(cfg, params, batch["tokens"], sh, places)
    B, S = x.shape[:2]
    cache = init_ssm_cache(cfg, B, x.device, sh)
    for i, lp in enumerate(gathered_layers(params, places, sh, cfg.n_layers, "layers")):
        h = apply_norm(cfg, lp["norm1"], x)
        y, s, c = mamba2.mamba2_block_state(cfg, lp["ssm"], h, sh)
        x = x + y
        cache["ssm"][i].copy_(s)
        cache["conv"][i].copy_(c)
    x = apply_norm(cfg, _used(params, places, sh, "final_norm"), x)
    logits = whole_logits(cfg, params, x[:, -1:], sh, places)
    cache["pos"].fill_(S)
    return logits, cache


@torch.no_grad()
def ssm_decode_step(cfg, params, cache, tokens, sharder=None, *, places):
    sh = mesh_sharder(sharder)
    x = embed_tokens(cfg, params, tokens, sh, places)
    for i, lp in enumerate(gathered_layers(params, places, sh, cfg.n_layers, "layers")):
        h = apply_norm(cfg, lp["norm1"], x)
        y, new = mamba2.mamba2_decode_step(
            cfg, lp["ssm"], h, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}, sh)
        x = x + y
        cache["ssm"][i].copy_(new["ssm"])
        cache["conv"][i].copy_(new["conv"])
    x = apply_norm(cfg, _used(params, places, sh, "final_norm"), x)
    logits = whole_logits(cfg, params, x, sh, places)
    pos = _as_tensor(cache["pos"], x.device, torch.int32)
    return logits, {"ssm": cache["ssm"], "conv": cache["conv"], "pos": pos + 1}

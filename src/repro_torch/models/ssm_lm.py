"""Mamba2 language model (attention-free): embed -> stacked SSD layers ->
head.

The same functions as ``repro.models.ssm_lm``, in PyTorch: a Python loop
over the stacked layer slices takes the place of ``lax.scan``, each layer
under the config's remat policy where a gradient is taken. The cache
is ``{"ssm": (L,B,H,P,N) f32, "conv": (L,B,W-1,Cd), "pos"}``: O(1) in the
context length, so ``seq_len`` sizes nothing. ``ssm_decode_step`` writes
the new states into the cache's tensors (JAX returns new arrays; the port
saves the copy) and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba2
from repro_torch.models.layers import (
    apply_norm, dense_init, embed_init, init_norm, softmax_xent,
)
from repro_torch.models.transformer import (
    _as_tensor, _stacked_norm, compute_dtype, embed_tokens,
    layer_slices, logits_fn, param_dtype, remat_wrap,
)
from repro_torch.parallel.sharding import padded_vocab, require_no_sharder


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


def forward_hidden(cfg, params, x, sharder=None):
    require_no_sharder(sharder)
    body = remat_wrap(cfg, lambda xx, lp: xx + mamba2.mamba2_block(
        cfg, lp["ssm"], apply_norm(cfg, lp["norm1"], xx)))
    for lp in layer_slices(params["layers"], cfg.n_layers):
        x = body(x, lp)
    return apply_norm(cfg, params["final_norm"], x)


def ssm_loss(cfg, params, batch, sharder=None):
    x = embed_tokens(cfg, params, batch["tokens"])
    h = forward_hidden(cfg, params, x, sharder)
    logits = logits_fn(cfg, params, h)
    loss = softmax_xent(logits, _as_tensor(batch["labels"], h.device, torch.long))
    return loss, {"xent": loss}


def init_ssm_cache(cfg, batch: int, device=None):
    cache = mamba2.init_mamba_cache(cfg, batch, compute_dtype(cfg), device,
                                    (cfg.n_layers,))
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


@torch.no_grad()
def ssm_prefill(cfg, params, batch, sharder=None):
    """Run the prompt via the chunked scan, capturing each layer's final
    states: (last-token logits, cache)."""
    require_no_sharder(sharder)
    x = embed_tokens(cfg, params, batch["tokens"])
    B, S = x.shape[:2]
    cache = init_ssm_cache(cfg, B, x.device)
    for i, lp in enumerate(layer_slices(params["layers"], cfg.n_layers)):
        h = apply_norm(cfg, lp["norm1"], x)
        y, s, c = mamba2.mamba2_block_state(cfg, lp["ssm"], h)
        x = x + y
        cache["ssm"][i].copy_(s)
        cache["conv"][i].copy_(c)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_fn(cfg, params, x[:, -1:])
    cache["pos"].fill_(S)
    return logits, cache


@torch.no_grad()
def ssm_decode_step(cfg, params, cache, tokens, sharder=None):
    require_no_sharder(sharder)
    x = embed_tokens(cfg, params, tokens)
    for i, lp in enumerate(layer_slices(params["layers"], cfg.n_layers)):
        h = apply_norm(cfg, lp["norm1"], x)
        y, new = mamba2.mamba2_decode_step(
            cfg, lp["ssm"], h, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]})
        x = x + y
        cache["ssm"][i].copy_(new["ssm"])
        cache["conv"][i].copy_(new["conv"])
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_fn(cfg, params, x)
    pos = _as_tensor(cache["pos"], x.device, torch.int32)
    return logits, {"ssm": cache["ssm"], "conv": cache["conv"], "pos": pos + 1}

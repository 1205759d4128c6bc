"""Encoder-decoder backbone (seamless-m4t style).

The same functions as ``repro.models.encdec``, in PyTorch (Python loops
over the stacked layers in the place of ``lax.scan``, each layer under the
config's remat policy where a gradient is taken). The encoder takes
precomputed modality-frontend embeddings (``src_embeds``) and runs
non-causal self-attention through ``sdpa``, which the ``cuda`` backend
sends to the flash kernel; the decoder is a causal stack with
cross-attention.

Serving: ``encdec_prefill`` encodes the source, computes every decoder
layer's cross-attention K/V once and primes the decoder with one decode
step of the BOS token (``tgt_tokens[:, :1]``); ``encdec_decode_step``
reuses the cross K/V (plain ``sdpa``, non-causal) and writes the self-
attention K/V row into the cache's tensors.

On a mesh (a ``sharder`` with one; ``places`` the blocks' placements,
``Model.places``) both stacks run as the transformer's do:
``src_embeds`` and the target tokens enter as the rank's batch rows, each
layer's leaves are gathered over ``"data"`` inside its checkpoint, the
encoder's self-attention (non-causal) and the decoder's (causal) go through
``attention.attention_tp`` and the MLPs through ``layers.apply_mlp``; the
target tokens' embedding, the logits and the cross-entropy are
vocab-parallel (``transformer.embed_tokens``, ``lm_xent``). The decoder's
cross-attention leaves (``decoder/layers/cross/w*``) match no rule of the
sharding (the rules' patterns need ``attn/``), so every rank holds them
whole, as JAX does, and runs the whole cross-attention on its batch rows
through ``sdpa`` (the flash kernel on the card). The prefill computes the
cross K/V once (the rank's rows, every head); the self-attention cache is
cut over ``"seq"`` as the transformer's (``attention.mesh_cache``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed_init, init_norm,
)
from repro_torch.models.transformer import (
    _as_tensor, _stacked_norm, _used, compute_dtype, embed_tokens, gathered_layers,
    lm_xent, make_positions, mesh_entry, param_dtype, remat_wrap, stack_layers,
    sub_places, whole_logits,
)
from repro_torch.parallel.sharding import mesh_sharder, padded_vocab


def _init_stack(cfg, gen, pdt, n, cross: bool):
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def attn_p():
        return {
            "wq": dense_init(gen, (n, d, hq * dh), d, pdt),
            "wk": dense_init(gen, (n, d, hkv * dh), d, pdt),
            "wv": dense_init(gen, (n, d, hkv * dh), d, pdt),
            "wo": dense_init(gen, (n, hq * dh, d), hq * dh, pdt),
        }

    p = {
        "attn": attn_p(),
        "mlp": {
            "wi": dense_init(gen, (n, d, f), d, pdt),
            "wo": dense_init(gen, (n, f, d), f, pdt),
        },
        "norm1": _stacked_norm(cfg, n, d, gen.device),
        "norm2": _stacked_norm(cfg, n, d, gen.device),
    }
    if cfg.act == "swiglu":
        p["mlp"]["wg"] = dense_init(gen, (n, d, f), d, pdt)
    if cross:
        p["cross"] = attn_p()
        p["norm3"] = _stacked_norm(cfg, n, d, gen.device)
    return p


def init_encdec(cfg, gen: torch.Generator) -> dict:
    """Random parameters in the JAX tree layout, drawn from ``gen`` on its
    device."""
    pdt = param_dtype(cfg)
    vp = padded_vocab(cfg.vocab)
    d, dev = cfg.d_model, gen.device
    params = {
        "embed": {"tok": embed_init(gen, (vp, d), pdt)},
        "encoder": {"layers": _init_stack(cfg, gen, pdt, cfg.encoder_layers, False),
                    "final_norm": init_norm(cfg, d, dev)},
        "decoder": {"layers": _init_stack(cfg, gen, pdt, cfg.n_layers, True),
                    "final_norm": init_norm(cfg, d, dev)},
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (d, vp), d, pdt)}
    return params


def _src(cfg, params, batch):
    dev = params["embed"]["tok"].device
    return _as_tensor(batch["src_embeds"], dev).to(compute_dtype(cfg))


def _final_norm(cfg, params, places, sh, name, x):
    return apply_norm(cfg, _used(params[name], sub_places(places, name), sh,
                                 "final_norm"), x)


def encode(cfg, params, src_embeds, sharder=None, impl="ref", places=None):
    """src_embeds (B,S,D) -> encoder hidden states."""
    sh = mesh_sharder(sharder)
    B, S, _ = src_embeds.shape
    positions = make_positions(cfg, B, S, src_embeds.device)
    whole, layers = stack_layers(params, places, sh, cfg.encoder_layers, "encoder",
                                 "layers")

    def layer(x, lp):
        lp = whole(lp)
        h = apply_norm(cfg, lp["norm1"], x)
        x = x + attn.attention_block(cfg, lp["attn"], h, positions, causal=False,
                                     sharder=sh, impl=impl)
        h2 = apply_norm(cfg, lp["norm2"], x)
        return x + apply_mlp(cfg, lp["mlp"], h2, sh)

    body = remat_wrap(cfg, layer)
    x = src_embeds
    for lp in layers:
        x = body(x, lp)
    return _final_norm(cfg, params, places, sh, "encoder", x)


def decode_train(cfg, params, tgt_tokens, enc_out, sharder=None, impl="ref",
                 places=None):
    """Teacher-forced decoder: tgt_tokens (B,S) -> final hidden states."""
    sh = mesh_sharder(sharder)
    x = embed_tokens(cfg, params, tgt_tokens, sh, places)
    B, S = x.shape[:2]
    positions = make_positions(cfg, B, S, x.device)
    whole, layers = stack_layers(params, places, sh, cfg.n_layers, "decoder", "layers")

    def layer(x, lp):
        lp = whole(lp)
        h = apply_norm(cfg, lp["norm1"], x)
        x = x + attn.attention_block(cfg, lp["attn"], h, positions, causal=True,
                                     sharder=sh, impl=impl)
        h2 = apply_norm(cfg, lp["norm3"], x)
        x = x + attn.cross_attention_block(cfg, lp["cross"], h2, enc_out, impl=impl)
        h3 = apply_norm(cfg, lp["norm2"], x)
        return x + apply_mlp(cfg, lp["mlp"], h3, sh)

    body = remat_wrap(cfg, layer)
    for lp in layers:
        x = body(x, lp)
    return _final_norm(cfg, params, places, sh, "decoder", x)


def encdec_loss(cfg, params, batch, sharder=None, impl="ref", *, places):
    sh, params = mesh_entry(sharder, params, places)
    enc_out = encode(cfg, params, _src(cfg, params, batch), sh, impl, places)
    h = decode_train(cfg, params, batch["tgt_tokens"], enc_out, sh, impl, places)
    loss = lm_xent(cfg, params, h, batch["labels"], sh, places)
    return loss, {"xent": loss}


# --------------------------------------------------------------------------- #
# Serving: prefill computes encoder output + cross-KV once; decode steps reuse.
# --------------------------------------------------------------------------- #
def init_encdec_cache(cfg, batch: int, seq_len: int, device=None):
    dh = cfg.resolved_head_dim
    cdt = compute_dtype(cfg)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, dh)
    cache = {key: torch.zeros(shape, dtype=cdt, device=device)
             for key in ("k", "v", "cross_k", "cross_v")}
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


@torch.no_grad()
def encdec_prefill(cfg, params, batch, seq_len, sharder=None, impl="ref", *,
                   places):
    """Encode the source, precompute each decoder layer's cross K/V (the
    source's length) and prime the decoder with the BOS token."""
    sh = mesh_sharder(sharder)
    cdt = compute_dtype(cfg)
    src = _src(cfg, params, batch)
    B = src.shape[0]
    enc_out = encode(cfg, params, src, sh, impl, places)
    dh = cfg.resolved_head_dim
    cross = params["decoder"]["layers"]["cross"]      # whole on every rank
    cache = init_encdec_cache(cfg, B, seq_len, src.device)
    attn.mesh_cache(cache, ("k", "v"), sh, seq_len)
    for key, w in (("cross_k", cross["wk"]), ("cross_v", cross["wv"])):
        # (B,S,D) @ (L,1,D,Hkv*dh): every layer's K or V of the source
        cache[key] = (enc_out @ w.to(cdt)[:, None]).reshape(
            cfg.n_layers, B, -1, cfg.n_kv_heads, dh)
    tgt = _as_tensor(batch["tgt_tokens"], src.device, torch.long)
    return encdec_decode_step(cfg, params, cache, tgt[:, :1], sh, places=places)


@torch.no_grad()
def encdec_decode_step(cfg, params, cache, tokens, sharder=None, *, places):
    sh = mesh_sharder(sharder)
    cdt = compute_dtype(cfg)
    x = embed_tokens(cfg, params, tokens, sh, places)
    pos = _as_tensor(cache["pos"], x.device, torch.int32)
    dh = cfg.resolved_head_dim
    B = x.shape[0]
    for i, lp in enumerate(gathered_layers(params, places, sh, cfg.n_layers, "decoder",
                                           "layers")):
        h = apply_norm(cfg, lp["norm1"], x)
        o, _, _ = attn.decode_attention(cfg, lp["attn"], h, cache["k"][i],
                                        cache["v"][i], pos, sharder=sh,
                                        slots=cache.get("slots"))
        x = x + o
        h2 = apply_norm(cfg, lp["norm3"], x)
        q = (h2 @ lp["cross"]["wq"].to(cdt)).reshape(B, 1, cfg.n_heads, dh)
        o2 = attn.sdpa(q, cache["cross_k"][i], cache["cross_v"][i], causal=False)
        x = x + o2.reshape(B, 1, -1) @ lp["cross"]["wo"].to(cdt)
        h3 = apply_norm(cfg, lp["norm2"], x)
        x = x + apply_mlp(cfg, lp["mlp"], h3, sh)
    x = _final_norm(cfg, params, places, sh, "decoder", x)
    logits = whole_logits(cfg, params, x, sh, places)
    return logits, dict(cache, pos=pos + 1)

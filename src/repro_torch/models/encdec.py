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
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed_init, init_norm, softmax_xent,
)
from repro_torch.models.transformer import (
    _as_tensor, _stacked_norm, compute_dtype, embed_tokens,
    layer_slices, logits_fn, make_positions, param_dtype, remat_wrap,
)
from repro_torch.parallel.sharding import padded_vocab, require_no_sharder


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


def encode(cfg, params, src_embeds, sharder=None, impl="ref"):
    """src_embeds (B,S,D) -> encoder hidden states."""
    require_no_sharder(sharder)
    B, S, _ = src_embeds.shape
    positions = make_positions(cfg, B, S, src_embeds.device)

    def layer(x, lp):
        h = apply_norm(cfg, lp["norm1"], x)
        x = x + attn.attention_block(cfg, lp["attn"], h, positions, causal=False,
                                     impl=impl)
        h2 = apply_norm(cfg, lp["norm2"], x)
        return x + apply_mlp(cfg, lp["mlp"], h2)

    body = remat_wrap(cfg, layer)
    x = src_embeds
    for lp in layer_slices(params["encoder"]["layers"], cfg.encoder_layers):
        x = body(x, lp)
    return apply_norm(cfg, params["encoder"]["final_norm"], x)


def decode_train(cfg, params, tgt_tokens, enc_out, sharder=None, impl="ref"):
    """Teacher-forced decoder: tgt_tokens (B,S) -> final hidden states."""
    require_no_sharder(sharder)
    x = embed_tokens(cfg, params, tgt_tokens)
    B, S = x.shape[:2]
    positions = make_positions(cfg, B, S, x.device)

    def layer(x, lp):
        h = apply_norm(cfg, lp["norm1"], x)
        x = x + attn.attention_block(cfg, lp["attn"], h, positions, causal=True,
                                     impl=impl)
        h2 = apply_norm(cfg, lp["norm3"], x)
        x = x + attn.cross_attention_block(cfg, lp["cross"], h2, enc_out, impl=impl)
        h3 = apply_norm(cfg, lp["norm2"], x)
        return x + apply_mlp(cfg, lp["mlp"], h3)

    body = remat_wrap(cfg, layer)
    for lp in layer_slices(params["decoder"]["layers"], cfg.n_layers):
        x = body(x, lp)
    return apply_norm(cfg, params["decoder"]["final_norm"], x)


def encdec_loss(cfg, params, batch, sharder=None, impl="ref"):
    enc_out = encode(cfg, params, _src(cfg, params, batch), sharder, impl)
    h = decode_train(cfg, params, batch["tgt_tokens"], enc_out, sharder, impl)
    logits = logits_fn(cfg, params, h)
    loss = softmax_xent(logits, _as_tensor(batch["labels"], h.device, torch.long))
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
def encdec_prefill(cfg, params, batch, seq_len, sharder=None, impl="ref"):
    """Encode the source, precompute each decoder layer's cross K/V (the
    source's length) and prime the decoder with the BOS token."""
    require_no_sharder(sharder)
    cdt = compute_dtype(cfg)
    src = _src(cfg, params, batch)
    B = src.shape[0]
    enc_out = encode(cfg, params, src, impl=impl)
    dh = cfg.resolved_head_dim
    cross = params["decoder"]["layers"]["cross"]
    cache = init_encdec_cache(cfg, B, seq_len, src.device)
    for key, w in (("cross_k", cross["wk"]), ("cross_v", cross["wv"])):
        # (B,S,D) @ (L,1,D,Hkv*dh): every layer's K or V of the source
        cache[key] = (enc_out @ w.to(cdt)[:, None]).reshape(
            cfg.n_layers, B, -1, cfg.n_kv_heads, dh)
    tgt = _as_tensor(batch["tgt_tokens"], src.device, torch.long)
    return encdec_decode_step(cfg, params, cache, tgt[:, :1])


@torch.no_grad()
def encdec_decode_step(cfg, params, cache, tokens, sharder=None):
    require_no_sharder(sharder)
    cdt = compute_dtype(cfg)
    x = embed_tokens(cfg, params, tokens)
    pos = _as_tensor(cache["pos"], x.device, torch.int32)
    dh = cfg.resolved_head_dim
    B = x.shape[0]
    for i, lp in enumerate(layer_slices(params["decoder"]["layers"],
                                        cfg.n_layers)):
        h = apply_norm(cfg, lp["norm1"], x)
        o, _, _ = attn.decode_attention(cfg, lp["attn"], h, cache["k"][i],
                                        cache["v"][i], pos)
        x = x + o
        h2 = apply_norm(cfg, lp["norm3"], x)
        q = (h2 @ lp["cross"]["wq"].to(cdt)).reshape(B, 1, cfg.n_heads, dh)
        o2 = attn.sdpa(q, cache["cross_k"][i], cache["cross_v"][i], causal=False)
        x = x + o2.reshape(B, 1, -1) @ lp["cross"]["wo"].to(cdt)
        h3 = apply_norm(cfg, lp["norm2"], x)
        x = x + apply_mlp(cfg, lp["mlp"], h3)
    x = apply_norm(cfg, params["decoder"]["final_norm"], x)
    logits = logits_fn(cfg, params, x)
    return logits, dict(cache, pos=pos + 1)

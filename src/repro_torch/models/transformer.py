"""Decoder-only transformer stack (dense / MoE / VLM families).

The same functions as ``repro.models.transformer``, in PyTorch. Layers stay
stacked on a leading L axis under the JAX package's tree keys; a Python loop
over the layer slices takes the place of ``lax.scan``. ``remat_wrap`` is the
config's remat policy as a per-layer activation checkpoint, applied where a
gradient is taken (the loss under autograd; prefill and decode never). An
MoE layer's FFN is ``moe.moe_block`` (plus the dense residual MLP where the
config has one); its auxiliary loss is summed over the layers. Decode steps
dispatch with ``"scatter"``, as JAX's do.

The KV cache is laid out the way ``init_cache`` / ``decode_step`` read it:
``prefill`` returns it at ``cache_len(cfg, seq_len)`` slots with position p
at slot p, or at slot ``p % W`` under a sliding window, so that decoding
continues the prompt. (The JAX package's ``prefill`` returns a cache of the
prompt's length, laid out from its last W tokens; see ROADMAP §C.)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed_init, init_norm, softmax_xent,
)
from repro_torch.parallel.sharding import padded_vocab, require_no_sharder
from repro_torch.precision import torch_dtype


def compute_dtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def param_dtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


#: the products ``remat="dots"`` saves: those with no batch dimension, as
#: ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` does
#: (a 2-D weight times activations folds to ``mm`` / ``addmm``; attention's
#: and the experts' batched products are ``bmm``, recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(cfg, fn):
    """``fn`` under the config's remat policy, as a non-reentrant activation
    checkpoint of one layer: ``"none"`` keeps every activation, ``"dots"``
    (the default) keeps the outputs of the non-batched products and
    recomputes the rest in the backward pass, anything else (``"full"``)
    keeps only the layer's inputs. Without grad mode (inference) ``fn``
    runs as it is. The forward draws no random numbers, so no RNG state is
    stashed."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False,
                                         preserve_rng_state=False, **kw)


def layer_slices(layers: dict, n: int) -> list:
    """The ``n`` layers of a stacked layer tree (views, no copies), each leaf
    unbound once: under autograd its backward stacks the layers' gradients
    in one write, where indexing each layer would add a zero-padded
    gradient of the whole stack per layer (quadratic in the depth)."""
    flat = {k: layer_slices(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in layers.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
def init_layer(cfg, gen: torch.Generator, pdt, n: int) -> dict:
    """Stacked params for n identical decoder layers."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dev = gen.device
    p: dict = {
        "attn": {
            "wq": dense_init(gen, (n, d, hq * dh), d, pdt),
            "wk": dense_init(gen, (n, d, hkv * dh), d, pdt),
            "wv": dense_init(gen, (n, d, hkv * dh), d, pdt),
            "wo": dense_init(gen, (n, hq * dh, d), hq * dh, pdt),
        },
        "norm1": _stacked_norm(cfg, n, d, dev),
        "norm2": _stacked_norm(cfg, n, d, dev),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p["attn"][name] = torch.zeros((n, heads * dh), dtype=pdt, device=dev)
    if cfg.moe is not None:
        e = cfg.moe.num_experts
        p["moe"] = {
            "router": dense_init(gen, (n, d, e), d, torch.float32),
            "wi": dense_init(gen, (n, e, d, f), d, pdt),
            "wo": dense_init(gen, (n, e, f, d), f, pdt),
        }
        if cfg.act == "swiglu":
            p["moe"]["wg"] = dense_init(gen, (n, e, d, f), d, pdt)
        if cfg.moe.dense_residual:     # JAX's tree: wi, wg, wo whatever act
            p["mlp"] = {
                "wi": dense_init(gen, (n, d, f), d, pdt),
                "wg": dense_init(gen, (n, d, f), d, pdt),
                "wo": dense_init(gen, (n, f, d), f, pdt),
            }
        return p
    p["mlp"] = {
        "wi": dense_init(gen, (n, d, f), d, pdt),
        "wo": dense_init(gen, (n, f, d), f, pdt),
    }
    if cfg.act == "swiglu":
        p["mlp"]["wg"] = dense_init(gen, (n, d, f), d, pdt)
    return p


def _stacked_norm(cfg, n, d, device):
    if cfg.norm == "nonparam_ln":
        return {}
    p = {"scale": torch.ones((n, d), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((n, d), dtype=torch.float32, device=device)
    return p


def init_lm(cfg, gen: torch.Generator) -> dict:
    """Random parameters in the JAX tree layout, drawn from ``gen`` on its
    device (truncated normals of JAX's stds; not JAX's bits)."""
    pdt = param_dtype(cfg)
    vp = padded_vocab(cfg.vocab)
    params = {
        "embed": {"tok": embed_init(gen, (vp, cfg.d_model), pdt)},
        "layers": init_layer(cfg, gen, pdt, cfg.n_layers),
        "final_norm": init_norm(cfg, cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (cfg.d_model, vp), cfg.d_model, pdt)}
    return params


# --------------------------------------------------------------------------- #
# Forward (prefill / loss)
# --------------------------------------------------------------------------- #
def _device(params) -> torch.device:
    return params["embed"]["tok"].device


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A tensor, or an array (numpy's bfloat16 too, as JAX hands it out), on
    ``device`` in ``dtype``."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        t = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
             if a.dtype.name == "bfloat16" else torch.as_tensor(a))
    return t.to(device=device, dtype=dtype)


def embed_tokens(cfg, params, tokens):
    """Rows of the embedding table in the compute dtype. Gathers first and
    casts the rows (the values of JAX's cast-then-gather, without casting
    the whole table on every call)."""
    table = params["embed"]["tok"]
    return table[_as_tensor(tokens, table.device, torch.long)].to(compute_dtype(cfg))


def make_positions(cfg, B, S, device=None):
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, B, S)
    return pos


def _inputs(cfg, params, batch):
    """The batch's embeddings (B,S,D) in the compute dtype and positions."""
    dev = _device(params)
    if cfg.input_mode == "embeds":
        x = _as_tensor(batch["embeds"], dev).to(compute_dtype(cfg))
        B, S, _ = x.shape
    else:
        x = embed_tokens(cfg, params, batch["tokens"])
        B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = make_positions(cfg, B, S, dev)
    else:
        positions = _as_tensor(positions, dev, torch.int32)
    return x, positions


def ffn(cfg, lp, h2, sharder=None, moe_dispatch="scatter"):
    """A layer's FFN on its normed input: (y, aux_loss). MoE layers route
    (and add the dense residual MLP where the config has one)."""
    if cfg.moe is None:
        return (apply_mlp(cfg, lp["mlp"], h2, sharder),
                torch.zeros((), dtype=torch.float32, device=h2.device))
    y, aux = moe_mod.moe_block(cfg, lp["moe"], h2, sharder, moe_dispatch)
    if cfg.moe.dense_residual:
        y = y + apply_mlp(cfg, lp["mlp"], h2, sharder)
    return y, aux


def block_fn(cfg, lp, x, positions, sharder=None, impl="ref",
             moe_dispatch="scatter"):
    """One decoder layer. Returns (x, aux_loss)."""
    h = apply_norm(cfg, lp["norm1"], x)
    a = attn.attention_block(cfg, lp["attn"], h, positions, causal=True,
                             sharder=sharder, impl=impl)
    x = x + a
    h2 = apply_norm(cfg, lp["norm2"], x)
    y, aux = ffn(cfg, lp, h2, sharder, moe_dispatch)
    return x + y, aux


def forward_hidden(cfg, params, x, positions, sharder=None, impl="ref",
                   moe_dispatch="scatter"):
    """x: (B,S,D) embeddings -> final hidden states (B,S,D), aux loss
    summed over the layers."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = remat_wrap(cfg, lambda xx, lp: block_fn(cfg, lp, xx, positions, sharder,
                                                   impl, moe_dispatch))
    for lp in layer_slices(params["layers"], cfg.n_layers):
        x, a = body(x, lp)
        aux = aux + a
    x = apply_norm(cfg, params["final_norm"], x)
    return x, aux


def logits_fn(cfg, params, h):
    cdt = h.dtype
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["tok"].to(cdt).T
    else:
        logits = h @ params["head"]["w"].to(cdt)
    vp = logits.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab entries
        neg = (torch.arange(vp, device=h.device) >= cfg.vocab).float() * -1e9
        logits = logits + neg.to(logits.dtype)
    return logits


def lm_loss(cfg, params, batch, sharder=None, impl="ref", moe_dispatch="scatter"):
    """Next-token cross-entropy plus the MoE auxiliary loss (differentiable
    through autograd: ``train.make_train_step`` takes its gradient)."""
    require_no_sharder(sharder)
    x, positions = _inputs(cfg, params, batch)
    h, aux = forward_hidden(cfg, params, x, positions, sharder, impl,
                            moe_dispatch)
    logits = logits_fn(cfg, params, h)
    loss = softmax_xent(logits, _as_tensor(batch["labels"], h.device, torch.long))
    return loss + aux, {"xent": loss, "aux": aux}


# --------------------------------------------------------------------------- #
# KV cache: prefill + decode
# --------------------------------------------------------------------------- #
def cache_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int, device=None):
    dh = cfg.resolved_head_dim
    S = cache_len(cfg, seq_len)
    cdt = compute_dtype(cfg)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, dh)
    return {
        "k": torch.zeros(shape, dtype=cdt, device=device),
        "v": torch.zeros(shape, dtype=cdt, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def prefill(cfg, params, batch, seq_len: int, sharder=None, impl="ref",
            moe_dispatch="scatter"):
    """Run the prompt through the stack, returning last-token logits + cache
    (``init_cache(cfg, B, seq_len)``'s layout, ready for ``decode_step``)."""
    require_no_sharder(sharder)
    cdt = compute_dtype(cfg)
    x, positions = _inputs(cfg, params, batch)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, seq_len, x.device)
    W = cache["k"].shape[2]
    if cfg.sliding_window is None and S > W:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"seq_len={seq_len}")
    # the last min(S, W) positions, each at its decode slot
    keep = min(S, W)
    slots = torch.arange(S - keep, S, device=x.device) % W
    for i, lp in enumerate(layer_slices(params["layers"], cfg.n_layers)):
        h = apply_norm(cfg, lp["norm1"], x)
        q, k, v = attn.qkv_proj(cfg, lp["attn"], h, positions)
        o = attn.sdpa(q, k, v, causal=True, window=cfg.sliding_window, impl=impl)
        x = x + o.reshape(B, S, -1) @ lp["attn"]["wo"].to(cdt)
        h2 = apply_norm(cfg, lp["norm2"], x)
        x = x + ffn(cfg, lp, h2, moe_dispatch=moe_dispatch)[0]
        cache["k"][i].index_copy_(1, slots, k[:, S - keep:])
        cache["v"][i].index_copy_(1, slots, v[:, S - keep:])
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_fn(cfg, params, x[:, -1:])
    cache["pos"].fill_(S)
    return logits, cache


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, sharder=None):
    """One decode step. tokens (B,1) int; cache from init_cache/prefill,
    whose k/v are updated in place (the returned cache holds the same
    tensors and ``pos + 1``)."""
    require_no_sharder(sharder)
    x = embed_tokens(cfg, params, tokens)
    pos = _as_tensor(cache["pos"], x.device, torch.int32)
    W = cfg.sliding_window
    for i, lp in enumerate(layer_slices(params["layers"], cfg.n_layers)):
        h = apply_norm(cfg, lp["norm1"], x)
        o, _, _ = attn.decode_attention(cfg, lp["attn"], h, cache["k"][i],
                                        cache["v"][i], pos, window=W)
        x = x + o
        h2 = apply_norm(cfg, lp["norm2"], x)
        x = x + ffn(cfg, lp, h2, moe_dispatch="scatter")[0]
    x = apply_norm(cfg, params["final_norm"], x)
    logits = logits_fn(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}

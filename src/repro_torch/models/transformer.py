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

On a mesh (a ``sharder`` holding one; the dense and MoE families) every
rank holds its blocks of the parameters (``parallel.sharding.shard_params``:
cut over ``"model"`` and over ``"data"``, JAX's ``param_shardings``) and of
the batch (cut over the sharder's batch axes), and computes what the JAX
package computes on that mesh:

- the placements come from the global shapes (``Model.places``, which
  ``Model.loss`` / ``prefill`` / ``decode_step`` hand down), never from a
  block's shape: a block of ``b`` rows with ``b % data != 0`` may be cut
  or whole;
- each weight the fsdp axes (``"data"``) cut is gathered whole over them
  where it is used (:func:`gather_fsdp`, :func:`stack_layers`): a layer's leaves inside the
  function ``remat_wrap`` checkpoints, so a rank holds one layer's weights
  whole over ``"data"`` at a time and the backward pass gathers them again
  (ZeRO-3); the embedding table, the head and the final norm at their
  use. The gather's backward reduce-scatters the gradient over ``"data"``
  where ``"data"`` is a batch axis, and keeps the rank's block of it where
  it is not (a batch that ``"data"`` does not divide: every data rank then
  computed the same whole gradient);
- the embedding table is cut over the vocabulary (``"model"``): a masked
  lookup of the rank's rows, then a psum;
- the logits are cut over the vocabulary too (``head/w``'s columns, or the
  tied table's rows), and :func:`lm_loss`'s cross-entropy is vocab-parallel
  (a pmax of the row maxima, psums of the exponentials' sums and of the
  label logits), JAX's ``softmax_xent`` on the whole logits;
- the loss is the mean over the global batch (a pmean over the batch
  axes), and each parameter enters the loss once over the batch axes it is
  held whole over (:func:`enter_batch`: all of them for a leaf ``"data"``
  does not cut, the others for one it cuts), so that every rank's gradient
  is its block of the global-batch gradient;
- :func:`prefill` returns the last token's logits whole on every rank and
  a cache cut over ``"seq"`` (its slots, where they divide the model axis;
  ``"slots"`` in the cache dict holds their global count), which
  :func:`decode_step` continues.

The VLM family runs the same path from its ``embeds`` and M-RoPE
``positions`` (3, B, S), both the rank's batch rows (the batch is
dimension 1 of the positions); its embedding table, which embeds mode
never reads, gets a zero gradient block. The SSM, hybrid and
encoder-decoder modules build on the helpers here (:func:`mesh_entry`,
:func:`stack_layers`, :func:`gathered_layers`, :func:`gather_fsdp`,
:func:`embed_tokens`, :func:`lm_xent`, :func:`whole_logits`).
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
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (Placement, _flatten_with_path,
                                           _unflatten_like, fsdp_split,
                                           mesh_sharder, model_split,
                                           padded_vocab)
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
# The fsdp split on a mesh
# --------------------------------------------------------------------------- #
def mesh_entry(sharder, params, places):
    """(sh, params) at a loss's start: the sharder with a mesh (or None) and
    the parameters entered over the batch axes (:func:`enter_batch`;
    ``places``: the blocks' placements)."""
    sh = mesh_sharder(sharder)
    return sh, enter_batch(params, sh, places)


def gather_fsdp(tree, places, sh):
    """``tree`` (a rank's blocks, ``places`` their placements) with every
    leaf the fsdp axes cut gathered whole over them
    (``collectives.gather_weight``: under autograd its backward
    reduce-scatters the gradient where the fsdp axes are batch axes, and
    keeps the rank's block of it where they are not). Without a mesh, or
    with fsdp axes of size 1, ``tree`` itself."""
    if sh is None or sh.mesh.axis_size(sh.axes("fsdp")) == 1:
        return tree
    fsdp = sh.axes("fsdp")
    summed = all(a in sh.axes("batch") for a in fsdp)
    out = []
    for (_, leaf), (_, p) in zip(_flatten_with_path(tree), _flatten_with_path(places)):
        for d in fsdp_split(p, sh)[0]:
            leaf = col.gather_weight(leaf, sh.mesh, fsdp, d, summed)
        out.append(leaf)
    return _unflatten_like(tree, out)


def _used(params, places, sh, key):
    """``params[key]`` whole over the fsdp axes, at its use."""
    return params[key] if sh is None else gather_fsdp(params[key], places[key], sh)


def sub_places(places, *keys):
    """``places[k1][k2]...``; None without a mesh."""
    for k in keys:
        places = None if places is None else places[k]
    return places


def layer_places(places, *keys):
    """One layer's placements, from those of the stacked layer tree at
    ``places[k1][k2]...`` (the L dimension dropped); None without a mesh."""
    stacked = sub_places(places, *keys)
    if stacked is None:
        return None
    flat = _flatten_with_path(stacked)
    return _unflatten_like(stacked, [Placement(p.mesh, tuple(p.spec[1:])) for _, p in flat])


def stack_layers(params, places, sh, n, *keys):
    """``(whole, layers)``: the ``n`` layer slices of the stacked tree at
    ``params[k1][k2]...`` and the function that gathers one of them whole
    over ``"data"`` (:func:`gather_fsdp`, :func:`layer_places`). Where a
    gradient is taken, call ``whole`` inside the checkpointed function."""
    stack = params
    for k in keys:
        stack = stack[k]
    lplaces = layer_places(places, *keys)
    return (lambda lp: gather_fsdp(lp, lplaces, sh)), layer_slices(stack, n)


def gathered_layers(params, places, sh, n, *keys):
    """The ``n`` layers of the stacked tree at ``params[k1][k2]...``, one at
    a time, each whole over ``"data"`` (serving: no checkpoint)."""
    whole, layers = stack_layers(params, places, sh, n, *keys)
    return map(whole, layers)


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


def embed_tokens(cfg, params, tokens, sharder=None, places=None):
    """Rows of the embedding table in the compute dtype. Gathers first and
    casts the rows (the values of JAX's cast-then-gather, without casting
    the whole table on every call). On a mesh the table is first gathered
    whole over ``"data"`` (``places``: the blocks' placements); where the
    model axis cuts the vocabulary, each rank looks up the tokens its rows
    hold (zeros for the rest) and a psum over ``"model"`` assembles them."""
    sh = mesh_sharder(sharder)
    table = _used(params, places, sh, "embed")["tok"]
    tokens = _as_tensor(tokens, table.device, torch.long)
    if sh is None or not model_split(sh, padded_vocab(cfg.vocab)):
        return table[tokens].to(compute_dtype(cfg))
    n = table.shape[0]
    t = tokens - sh.mesh.axis_index("model") * n
    ok = (t >= 0) & (t < n)
    rows = table[t.clamp(0, n - 1)].to(compute_dtype(cfg)) * ok[..., None]
    return col.reduce(rows, sh.mesh, "model")


def make_positions(cfg, B, S, device=None):
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, B, S)
    return pos


def _inputs(cfg, params, batch, sharder=None, places=None):
    """The batch's embeddings (B,S,D) in the compute dtype and positions."""
    dev = _device(params)
    if cfg.input_mode == "embeds":
        x = _as_tensor(batch["embeds"], dev).to(compute_dtype(cfg))
        B, S, _ = x.shape
    else:
        x = embed_tokens(cfg, params, batch["tokens"], sharder, places)
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
                   moe_dispatch="scatter", places=None):
    """x: (B,S,D) embeddings -> final hidden states (B,S,D), aux loss
    summed over the layers. On a mesh (``places``: the blocks' placements)
    each layer gathers its leaves over ``"data"`` inside the checkpointed
    function (see the module docstring)."""
    sh = mesh_sharder(sharder)
    whole, layers = stack_layers(params, places, sh, cfg.n_layers, "layers")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = remat_wrap(cfg, lambda xx, lp: block_fn(
        cfg, whole(lp), xx, positions, sharder, impl, moe_dispatch))
    for lp in layers:
        x, a = body(x, lp)
        aux = aux + a
    x = apply_norm(cfg, _used(params, places, sh, "final_norm"), x)
    return x, aux


def logits_fn(cfg, params, h, sharder=None, places=None):
    """The logits (..., Vp), padded entries masked. On a mesh (``places``:
    the blocks' placements) the head (or the tied table) is gathered whole
    over ``"data"`` first; where the
    model axis cuts the vocabulary: this rank's block of them
    (``"model"``'s index times the block's width is its first vocabulary
    entry)."""
    cdt = h.dtype
    sh = mesh_sharder(sharder)
    split = sh is not None and model_split(sh, padded_vocab(cfg.vocab))
    if split:
        h = col.enter(h, sh.mesh, "model")
    if cfg.tie_embeddings:
        logits = h @ _used(params, places, sh, "embed")["tok"].to(cdt).T
    else:
        logits = h @ _used(params, places, sh, "head")["w"].to(cdt)
    vp = logits.shape[-1]
    lo = sh.mesh.axis_index("model") * vp if split else 0
    if lo + vp > cfg.vocab:  # mask padded vocab entries
        neg = (torch.arange(lo, lo + vp, device=h.device) >= cfg.vocab).float() * -1e9
        logits = logits + neg.to(logits.dtype)
    return logits


def whole_logits(cfg, params, h, sh, places):
    """Every vocabulary entry's logit on every rank (serving; no gradient)."""
    logits = logits_fn(cfg, params, h, sh, places)
    if sh is not None and model_split(sh, padded_vocab(cfg.vocab)):
        logits = col.all_gather_dim(logits.detach(), sh.mesh, "model", -1)
    return logits


def _xent_vocab_parallel(logits, labels, sh, z_loss: float = 1e-4):
    """``softmax_xent(whole logits, labels)`` (no mask) from this rank's
    vocabulary block: a pmax of the row maxima (the shift, no gradient),
    psums of the exponentials' sums and of the label logits; the mean over
    this rank's tokens."""
    mesh = sh.mesh
    x = logits.float()
    n = x.shape[-1]
    top = col.pmax(x.amax(-1), mesh, "model")
    se = col.reduce(torch.exp(x - top[..., None]).sum(-1), mesh, "model")
    lse = top + torch.log(se)
    t = labels - mesh.axis_index("model") * n
    ok = (t >= 0) & (t < n)
    ll = torch.gather(x, -1, t.clamp(0, n - 1)[..., None])[..., 0] * ok
    loss = lse - col.reduce(ll, mesh, "model")
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss.mean()


def enter_batch(params, sh, places):
    """The parameters (a tree of a rank's blocks, ``places`` their
    placements) entering a loss on a mesh: each leaf over the batch axes it
    is held whole over (``sharding.fsdp_split``), so that the backward pass
    sums its gradient over them; a leaf the fsdp axes cut has the rest of
    the sum from its gather's reduce-scatter. Together: the global-batch
    gradient, which JAX's partitioner sums the same."""
    if sh is None or sh.mesh.axis_size(sh.axes("batch")) == 1:
        return params
    out = [col.enter(p, sh.mesh, fsdp_split(pl, sh)[1]) if p.is_floating_point() else p
           for (_, p), (_, pl) in zip(_flatten_with_path(params),
                                      _flatten_with_path(places))]
    return _unflatten_like(params, out)


def lm_xent(cfg, params, h, labels, sh, places):
    """The next-token cross-entropy of the final hidden states ``h``
    (``softmax_xent``, JAX's): on a mesh vocab-parallel where the model
    axis cuts the vocabulary, and the global batch's mean (a pmean over the
    batch axes)."""
    logits = logits_fn(cfg, params, h, sh, places)
    labels = _as_tensor(labels, h.device, torch.long)
    if sh is not None and model_split(sh, padded_vocab(cfg.vocab)):
        loss = _xent_vocab_parallel(logits, labels, sh)
    else:
        loss = softmax_xent(logits, labels)
    if sh is not None:
        loss = col.leave(col.pmean(loss, sh.mesh, sh.axes("batch")), sh.mesh,
                         sh.axes("batch"))
    return loss


def lm_loss(cfg, params, batch, sharder=None, impl="ref", moe_dispatch="scatter", *,
            places):
    """Next-token cross-entropy plus the MoE auxiliary loss (differentiable
    through autograd: ``train.make_train_step`` takes its gradient). On a
    mesh the rank's loss is the global batch's (see the module docstring;
    an ``a2a`` layer's auxiliary loss is the rank's own, as JAX's shard_map
    returns it) and its gradient the rank's block of the global one.
    ``places``: the blocks' placements (``Model.places``; None without a
    mesh)."""
    sh, params = mesh_entry(sharder, params, places)
    x, positions = _inputs(cfg, params, batch, sh, places)
    h, aux = forward_hidden(cfg, params, x, positions, sh, impl,
                            moe_dispatch, places)
    loss = lm_xent(cfg, params, h, batch["labels"], sh, places)
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
            moe_dispatch="scatter", *, places):
    """Run the prompt through the stack, returning last-token logits + cache
    (``init_cache(cfg, B, seq_len)``'s layout, ready for ``decode_step``;
    on a mesh this rank's slots of it, see the module docstring).
    ``places``: the blocks' placements (None without a mesh)."""
    sh = mesh_sharder(sharder)
    cdt = compute_dtype(cfg)
    x, positions = _inputs(cfg, params, batch, sh, places)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, seq_len, x.device)
    W = cache["k"].shape[2]
    if cfg.sliding_window is None and S > W:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"seq_len={seq_len}")
    lo, c = attn.mesh_cache(cache, ("k", "v"), sh, W)
    dst, src = attn.prompt_slots(S, W, lo, c, x.device)
    for i, lp in enumerate(gathered_layers(params, places, sh, cfg.n_layers, "layers")):
        h = apply_norm(cfg, lp["norm1"], x)
        o, k, v = attn.attention_with_kv(cfg, lp["attn"], h, positions, sh,
                                         window=cfg.sliding_window, impl=impl)
        x = x + o
        h2 = apply_norm(cfg, lp["norm2"], x)
        x = x + ffn(cfg, lp, h2, sh, moe_dispatch=moe_dispatch)[0]
        cache["k"][i].index_copy_(1, dst, k[:, src].to(cdt))
        cache["v"][i].index_copy_(1, dst, v[:, src].to(cdt))
    x = apply_norm(cfg, _used(params, places, sh, "final_norm"), x)
    logits = whole_logits(cfg, params, x[:, -1:], sh, places)
    cache["pos"].fill_(S)
    return logits, cache


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, sharder=None, *, places):
    """One decode step. tokens (B,1) int; cache from init_cache/prefill,
    whose k/v are updated in place (the returned cache holds the same
    tensors and ``pos + 1``). On a mesh the cache is the mesh prefill's:
    this rank's slots, ``cache["slots"]`` of them in all; ``places``: the
    blocks' placements (None without a mesh)."""
    sh = mesh_sharder(sharder)
    x = embed_tokens(cfg, params, tokens, sh, places)
    pos = _as_tensor(cache["pos"], x.device, torch.int32)
    W = cfg.sliding_window
    slots = cache.get("slots")
    for i, lp in enumerate(gathered_layers(params, places, sh, cfg.n_layers, "layers")):
        h = apply_norm(cfg, lp["norm1"], x)
        o, _, _ = attn.decode_attention(cfg, lp["attn"], h, cache["k"][i],
                                        cache["v"][i], pos, window=W,
                                        sharder=sh, slots=slots)
        x = x + o
        h2 = apply_norm(cfg, lp["norm2"], x)
        x = x + ffn(cfg, lp, h2, sh, moe_dispatch="scatter")[0]
    x = apply_norm(cfg, _used(params, places, sh, "final_norm"), x)
    logits = whole_logits(cfg, params, x, sh, places)
    out = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    if slots is not None:
        out["slots"] = slots
    return logits, out

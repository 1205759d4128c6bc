"""Unified model API: build_model(config) -> Model with init/loss/prefill/decode.

The port's counterpart of ``repro.models.api``: every family builds
(``dense``, ``moe`` and ``vlm`` the transformer stack, ``ssm``, ``hybrid``
and ``encdec`` their own modules), with the JAX package's signatures.

The entry points run on the card unless the caller asks for the CPU:
``init`` and ``init_cache`` take ``device="auto"`` (the GPU; raises without
one), ``prefill`` and ``loss`` take ``impl="auto"`` (the ``cuda`` backend;
raises without a GPU), also where a family has no attention for ``impl``
to choose. ``device="cpu"`` with ``impl="ref"`` runs the plain PyTorch
versions on the CPU. ``moe_dispatch`` takes JAX's names.

``sharder``: None or a mesh-less ``Sharder`` is the single-card path; a
``Sharder`` on a mesh runs every family sharded, each rank with its
blocks of the parameters, cut over ``"model"`` and ``"data"``
(``init(..., sharder=)``, which cuts each leaf as it is drawn, or
``parallel.sharding.shard_params`` of a global tree, e.g. JAX's ``init``
carried across by ``interop.lm_params_from_numpy``) and of the batch (each
input cut on its batch dimension: ``launch.train.batch_block``); ``loss``,
``prefill`` and ``decode_step`` hand the family the blocks' placements,
``held_shardings(param_specs())`` (from the global shapes, never from a
block's). Anything that is not a ``Sharder`` raises ``TypeError``.

``param_specs()`` gives ``init``'s tree as shapes (the large leaves on
the meta device, nothing drawn), as ``jax.eval_shape`` does.
``input_specs(shape)`` gives the inputs a family takes at a
``ShapeConfig`` as shape-and-dtype stand-ins: tensors on ``device="meta"``
(no storage, nothing executes), with the JAX package's keys, shapes and
dtypes. The training driver fills them (``launch.train.synth_batch``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import backends
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models.layers import cut_draws, shapes_only
from repro_torch.models.moe import DISPATCHES
from repro_torch.parallel.sharding import (_flatten_with_path, _unflatten_like,
                                           held_shardings, mesh_sharder)
from repro_torch.precision import torch_dtype


@dataclass
class Model:
    config: ModelConfig
    init: Callable[..., Any]                         # (seed | Generator, device, sharder) -> params
    loss: Callable[..., tuple]                       # (params, batch, sharder, impl) -> (loss, metrics)
    prefill: Optional[Callable[..., tuple]]          # (params, batch, seq_len, sharder, impl) -> (logits, cache)
    decode_step: Optional[Callable[..., tuple]]      # (params, cache, tokens, sharder) -> (logits, cache)
    init_cache: Optional[Callable[..., Any]]         # (batch, seq_len, device) -> cache
    input_specs: Callable[[ShapeConfig], dict]       # meta-tensor stand-ins
    param_specs: Callable[[], Any]                   # () -> init's tree, shapes only


def build_model(cfg: ModelConfig, moe_dispatch: str = "scatter") -> Model:
    if moe_dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}; one of {DISPATCHES}")
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return _build_transformer(cfg, moe_dispatch)
    if fam == "ssm":
        return _build_ssm(cfg)
    if fam == "hybrid":
        return _build_hybrid(cfg)
    if fam == "encdec":
        return _build_encdec(cfg)
    raise ValueError(f"unknown family {fam!r}")


# --------------------------------------------------------------------------- #
def _sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the meta device."""
    dt = torch.int32 if dtype == "int32" else torch_dtype(dtype)
    return torch.empty(shape, dtype=dt, device="meta")


def _lm_token_specs(cfg, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": _sds((B, S), "int32"), "labels": _sds((B, S), "int32")}
    if shape.kind == "prefill":
        return {"tokens": _sds((B, S), "int32")}
    return {"tokens": _sds((B, 1), "int32")}          # decode


def _embeds_specs(cfg, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    cdt = cfg.compute_dtype
    if cfg.family == "encdec":
        if shape.kind == "train":
            return {"src_embeds": _sds((B, S, d), cdt),
                    "tgt_tokens": _sds((B, S), "int32"),
                    "labels": _sds((B, S), "int32")}
        if shape.kind == "prefill":
            return {"src_embeds": _sds((B, S, d), cdt),
                    "tgt_tokens": _sds((B, 1), "int32")}
        return {"tokens": _sds((B, 1), "int32")}
    # vlm: precomputed patch/text embeddings + M-RoPE positions
    if shape.kind == "train":
        return {"embeds": _sds((B, S, d), cdt),
                "labels": _sds((B, S), "int32"),
                "positions": _sds((3, B, S), "int32")}
    if shape.kind == "prefill":
        return {"embeds": _sds((B, S, d), cdt),
                "positions": _sds((3, B, S), "int32")}
    return {"tokens": _sds((B, 1), "int32")}


def _specs_of(cfg):
    specs = _embeds_specs if cfg.input_mode == "embeds" else _lm_token_specs
    return lambda shape: specs(cfg, shape)


# --------------------------------------------------------------------------- #
def _generator(rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=backends.resolve_device(device))
    gen.manual_seed(int(rng))
    return gen


def _init_blocks(cfg, init_fn, gen, sh):
    """This rank's blocks of ``init_fn(gen)`` on ``sh``'s mesh, bit for bit
    ``shard_params`` of it, without the whole tree: each drawn leaf is cut
    to its block as it is drawn (``layers.cut_draws``), so a rank holds its
    blocks plus one leaf's draw (one chunk of a wide narrow-dtype leaf) at a
    time; what is not drawn (norm scales, biases) is cut after."""
    drawn: list = []
    with shapes_only(drawn):
        specs = init_fn(torch.Generator())
    pairs = [(leaf, p) for (_, leaf), (_, p) in zip(
        _flatten_with_path(specs), _flatten_with_path(held_shardings(specs, cfg, sh)))]
    at = {id(leaf): p for leaf, p in pairs}
    with cut_draws([at[id(t)].slices(t.shape) for t in drawn]):   # every draw is a leaf
        params = init_fn(gen)

    def block(leaf, spec, p):
        if tuple(leaf.shape) != tuple(spec.shape):       # cut as drawn
            return leaf
        b = p.local(leaf)
        return b.clone() if b.shape != leaf.shape else leaf

    return _unflatten_like(params, [block(leaf, spec, p) for (_, leaf), (spec, p) in
                                    zip(_flatten_with_path(params), pairs)])


def _model(cfg, init_fn, loss_fn, prefill_fn, decode_fn, cache_fn) -> Model:
    """A Model whose entry points resolve ``device`` / ``impl`` (``"auto"``:
    the card) before they call the family's functions, and hand them the
    blocks' placements on a mesh (None without one)."""

    def init(rng=0, device="auto", sharder=None):
        """``rng``: an int seed or a ``torch.Generator`` (its device wins).
        With a ``sharder`` on a mesh, this rank's blocks of the same tree
        (:func:`_init_blocks`)."""
        gen = _generator(rng, device)
        sh = mesh_sharder(sharder)
        return init_fn(gen) if sh is None else _init_blocks(cfg, init_fn, gen, sh)

    def param_specs():
        """``init``'s tree with its shapes and dtypes and nothing drawn
        (the large leaves on the meta device): JAX's ``jax.eval_shape`` of
        ``init``, which the placements of a mesh need."""
        with shapes_only():
            return init_fn(torch.Generator())

    def places(sharder):
        sh = mesh_sharder(sharder)
        return None if sh is None else held_shardings(param_specs(), cfg, sh)

    def loss(params, batch, sharder=None, impl="auto"):
        return loss_fn(params, batch, sharder, backends.resolve(impl),
                       places=places(sharder))

    def prefill(params, batch, seq_len, sharder=None, impl="auto"):
        return prefill_fn(params, batch, seq_len, sharder, backends.resolve(impl),
                          places=places(sharder))

    def decode_step(params, cache, tokens, sharder=None):
        return decode_fn(params, cache, tokens, sharder, places=places(sharder))

    def init_cache(batch, seq_len, device="auto"):
        return cache_fn(batch, seq_len, backends.resolve_device(device))

    return Model(cfg, init, loss, prefill, decode_step, init_cache, _specs_of(cfg),
                 param_specs)


def _build_transformer(cfg, moe_dispatch="scatter") -> Model:
    t = transformer
    return _model(
        cfg,
        lambda gen: t.init_lm(cfg, gen),
        lambda params, batch, sh, impl, places: t.lm_loss(
            cfg, params, batch, sh, impl, moe_dispatch, places=places),
        lambda params, batch, seq_len, sh, impl, places: t.prefill(
            cfg, params, batch, seq_len, sh, impl, moe_dispatch, places=places),
        lambda params, cache, tokens, sh, places: t.decode_step(
            cfg, params, cache, tokens, sh, places=places),
        lambda batch, seq_len, device: t.init_cache(cfg, batch, seq_len, device),
    )


def _build_ssm(cfg) -> Model:
    m = ssm_lm
    # O(1) state: the SSM cache does not scale with context length, and the
    # prefill has no attention for ``impl`` to route
    return _model(
        cfg,
        lambda gen: m.init_ssm_lm(cfg, gen),
        lambda params, batch, sh, impl, places: m.ssm_loss(
            cfg, params, batch, sh, places=places),
        lambda params, batch, seq_len, sh, impl, places: m.ssm_prefill(
            cfg, params, batch, sh, places=places),
        lambda params, cache, tokens, sh, places: m.ssm_decode_step(
            cfg, params, cache, tokens, sh, places=places),
        lambda batch, seq_len, device: m.init_ssm_cache(cfg, batch, device),
    )


def _build_hybrid(cfg) -> Model:
    h = hybrid
    return _model(
        cfg,
        lambda gen: h.init_hybrid(cfg, gen),
        lambda params, batch, sh, impl, places: h.hybrid_loss(
            cfg, params, batch, sh, impl, places=places),
        lambda params, batch, seq_len, sh, impl, places: h.hybrid_prefill(
            cfg, params, batch, seq_len, sh, impl, places=places),
        lambda params, cache, tokens, sh, places: h.hybrid_decode_step(
            cfg, params, cache, tokens, sh, places=places),
        lambda batch, seq_len, device: h.init_hybrid_cache(cfg, batch, seq_len,
                                                           device),
    )


def _build_encdec(cfg) -> Model:
    e = encdec
    return _model(
        cfg,
        lambda gen: e.init_encdec(cfg, gen),
        lambda params, batch, sh, impl, places: e.encdec_loss(
            cfg, params, batch, sh, impl, places=places),
        lambda params, batch, seq_len, sh, impl, places: e.encdec_prefill(
            cfg, params, batch, seq_len, sh, impl, places=places),
        lambda params, cache, tokens, sh, places: e.encdec_decode_step(
            cfg, params, cache, tokens, sh, places=places),
        lambda batch, seq_len, device: e.init_encdec_cache(cfg, batch, seq_len,
                                                           device),
    )

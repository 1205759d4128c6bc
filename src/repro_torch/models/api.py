"""Unified model API: build_model(config) -> Model with init/loss/prefill/decode.

The port's counterpart of ``repro.models.api``: every family builds
(``dense``, ``moe`` and ``vlm`` the transformer stack, ``ssm``, ``hybrid``
and ``encdec`` their own modules), with the JAX package's signatures.

The entry points run on the card unless the caller asks for the CPU:
``init`` and ``init_cache`` take ``device="auto"`` (the GPU; raises without
one), ``prefill`` and ``loss`` take ``impl="auto"`` (the ``cuda`` backend;
raises without a GPU), also where a family has no attention for ``impl``
to choose. ``device="cpu"`` with ``impl="ref"`` runs the plain PyTorch
versions on the CPU. ``moe_dispatch`` takes JAX's names; ``"a2a"`` and a
``sharder`` (a mesh) raise ``NotImplementedError`` naming ROADMAP item 16.
JAX's ``input_specs`` (the trainer's and the dry-run's shape stand-ins)
waits for the LM training slice (ROADMAP item 16).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import backends
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models.moe import DISPATCHES, moe_block_a2a


@dataclass
class Model:
    config: ModelConfig
    init: Callable[..., Any]                         # (seed | Generator, device) -> params
    loss: Callable[..., tuple]                       # (params, batch, sharder, impl) -> (loss, metrics)
    prefill: Optional[Callable[..., tuple]]          # (params, batch, seq_len, sharder, impl) -> (logits, cache)
    decode_step: Optional[Callable[..., tuple]]      # (params, cache, tokens, sharder) -> (logits, cache)
    init_cache: Optional[Callable[..., Any]]         # (batch, seq_len, device) -> cache


def build_model(cfg: ModelConfig, moe_dispatch: str = "scatter") -> Model:
    if moe_dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}; one of {DISPATCHES}")
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        if cfg.moe is not None and moe_dispatch == "a2a":
            moe_block_a2a(cfg, None, None)           # raises: no mesh (item 16)
        return _build_transformer(cfg, moe_dispatch)
    if fam == "ssm":
        return _build_ssm(cfg)
    if fam == "hybrid":
        return _build_hybrid(cfg)
    if fam == "encdec":
        return _build_encdec(cfg)
    raise ValueError(f"unknown family {fam!r}")


def _generator(rng, device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=backends.resolve_device(device))
    gen.manual_seed(int(rng))
    return gen


def _model(cfg, init_fn, loss_fn, prefill_fn, decode_fn, cache_fn) -> Model:
    """A Model whose entry points resolve ``device`` / ``impl`` (``"auto"``:
    the card) before they call the family's functions."""

    def init(rng=0, device="auto"):
        """``rng``: an int seed or a ``torch.Generator`` (its device wins)."""
        return init_fn(_generator(rng, device))

    def loss(params, batch, sharder=None, impl="auto"):
        return loss_fn(params, batch, sharder, backends.resolve(impl))

    def prefill(params, batch, seq_len, sharder=None, impl="auto"):
        return prefill_fn(params, batch, seq_len, sharder, backends.resolve(impl))

    def init_cache(batch, seq_len, device="auto"):
        return cache_fn(batch, seq_len, backends.resolve_device(device))

    return Model(cfg, init, loss, prefill, decode_fn, init_cache)


def _build_transformer(cfg, moe_dispatch="scatter") -> Model:
    t = transformer
    return _model(
        cfg,
        lambda gen: t.init_lm(cfg, gen),
        lambda params, batch, sharder, impl: t.lm_loss(
            cfg, params, batch, sharder, impl, moe_dispatch),
        lambda params, batch, seq_len, sharder, impl: t.prefill(
            cfg, params, batch, seq_len, sharder, impl, moe_dispatch),
        lambda params, cache, tokens, sharder=None: t.decode_step(
            cfg, params, cache, tokens, sharder),
        lambda batch, seq_len, device: t.init_cache(cfg, batch, seq_len, device),
    )


def _build_ssm(cfg) -> Model:
    m = ssm_lm
    # O(1) state: the SSM cache does not scale with context length, and the
    # prefill has no attention for ``impl`` to route
    return _model(
        cfg,
        lambda gen: m.init_ssm_lm(cfg, gen),
        lambda params, batch, sharder, impl: m.ssm_loss(cfg, params, batch, sharder),
        lambda params, batch, seq_len, sharder, impl: m.ssm_prefill(
            cfg, params, batch, sharder),
        lambda params, cache, tokens, sharder=None: m.ssm_decode_step(
            cfg, params, cache, tokens, sharder),
        lambda batch, seq_len, device: m.init_ssm_cache(cfg, batch, device),
    )


def _build_hybrid(cfg) -> Model:
    h = hybrid
    return _model(
        cfg,
        lambda gen: h.init_hybrid(cfg, gen),
        lambda params, batch, sharder, impl: h.hybrid_loss(
            cfg, params, batch, sharder, impl),
        lambda params, batch, seq_len, sharder, impl: h.hybrid_prefill(
            cfg, params, batch, seq_len, sharder, impl),
        lambda params, cache, tokens, sharder=None: h.hybrid_decode_step(
            cfg, params, cache, tokens, sharder),
        lambda batch, seq_len, device: h.init_hybrid_cache(cfg, batch, seq_len,
                                                           device),
    )


def _build_encdec(cfg) -> Model:
    e = encdec
    return _model(
        cfg,
        lambda gen: e.init_encdec(cfg, gen),
        lambda params, batch, sharder, impl: e.encdec_loss(
            cfg, params, batch, sharder, impl),
        lambda params, batch, seq_len, sharder, impl: e.encdec_prefill(
            cfg, params, batch, seq_len, sharder, impl),
        lambda params, cache, tokens, sharder=None: e.encdec_decode_step(
            cfg, params, cache, tokens, sharder),
        lambda batch, seq_len, device: e.init_encdec_cache(cfg, batch, seq_len,
                                                           device),
    )
